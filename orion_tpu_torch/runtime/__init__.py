"""The native host runtime: ctypes bindings over the C++ data loader, byte
encoder, BPE encoder and corpus sampler, with the pure-Python twins as the
fallback. The port's counterpart of ``orion_tpu/runtime/__init__.py``.

``loader.cc``, ``tokenizer.cc``, ``bpe.cc`` and ``corpusgen.cc`` beside this
file are the JAX package's sources, their code line for line (comments
trimmed; ``tests/test_torch_package.py`` holds them to it). They are compiled
with g++ at first use into one shared library under ``orion_tpu_torch/_build/``,
named by a hash of the sources, the flags and the compiler's version (an
edit of any rebuilds), written to a temporary name and renamed, so two
processes may build at once. Nothing is built while this module is imported.

Every entry here has a twin with the same determinism contract (the
splitmix64 window stream of ``training/data.py``, the byte vocabulary, the
BPE merge order of ``utils/bpe.py``, the draw stream of
``training/corpusgen.py``), so the native path is a speedup only, bitwise
the Python one. The fallback is never silent: without g++ the twins run and
one line on stderr says so; a compile that fails raises with g++'s output.
:func:`native_available` says which path is live.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCES = tuple(HERE / f"{name}.cc" for name in ("loader", "tokenizer", "bpe", "corpusgen"))
BUILD_DIR = HERE.parent / "_build"
# no -march=native: a library built on one host must run on another that
# shares the checkout's build directory
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++")


def _compiler_version(cxx: str) -> str:
    proc = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    return proc.stdout.splitlines()[0] if proc.stdout else ""


def library_path(cxx: str) -> Path:
    """Where the library built by ``cxx`` lives: its name hashes the
    sources, the flags, the compiler's version and the machine."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_compiler_version(cxx).encode())
    h.update(platform.machine().encode())
    return BUILD_DIR / f"liborion_runtime-{h.hexdigest()[:16]}.so"


def build(cxx: Optional[str] = None) -> Path:
    """Compile the library with ``cxx`` (default: ``$CXX`` or g++) if it
    has no build yet; returns its path. Raises with the compiler's output
    when the compile fails, and RuntimeError when there is no compiler."""
    cxx = cxx or _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build the native runtime")
    path = library_path(cxx)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *FLAGS, *map(str, SOURCES), "-o", tmp],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) building the native "
                               f"runtime:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    sigs = {
        "orion_loader_open": (c.c_void_p, [c.c_char_p, c.c_int64, c.c_int]),
        "orion_loader_n_tokens": (c.c_int64, [c.c_void_p]),
        "orion_loader_batch": (None, [c.c_void_p, c.c_uint64, c.c_uint64, c.c_int64,
                                      c.POINTER(c.c_int32), c.c_int]),
        "orion_loader_gather": (None, [c.c_void_p, c.POINTER(c.c_int64), c.c_int64,
                                       c.POINTER(c.c_int32), c.c_int]),
        "orion_loader_close": (None, [c.c_void_p]),
        "orion_byte_encode_file": (c.c_int64, [c.c_char_p, c.c_char_p]),
        "orion_corpusgen_fit": (c.c_void_p, [c.POINTER(c.c_uint16), c.c_int64]),
        "orion_corpusgen_sample": (None, [c.c_void_p, c.c_uint64, c.c_double, c.c_double,
                                          c.c_int64, c.POINTER(c.c_uint16)]),
        "orion_corpusgen_destroy": (None, [c.c_void_p]),
        "orion_bpe_create": (c.c_void_p, [c.POINTER(c.c_int32), c.c_int64]),
        "orion_bpe_destroy": (None, [c.c_void_p]),
        "orion_bpe_encode": (c.c_int64, [c.c_void_p, c.c_char_p, c.c_int64,
                                         c.POINTER(c.c_int32)]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None (after one stderr line)
    when there is no compiler."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        cxx = _compiler()
        if cxx is None:
            _tried = True
            print("orion_tpu_torch.runtime: no g++ (or $CXX) on this host; the data loader, "
                  "byte encoder, BPE and corpus sampler run their Python twins",
                  file=sys.stderr, flush=True)
            return None
        _lib = _bind(ctypes.CDLL(str(build(cxx))))
        _tried = True
        return _lib


def native_available() -> bool:
    """Is the native path live (the library built and loaded)?"""
    return _load() is not None


def _meta_dtype(path: str):
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        dtype = np.dtype(meta["dtype"])
        return dtype, int(meta.get("vocab_size", np.iinfo(dtype).max + 1))
    return np.dtype(np.uint16), 65536


class NativeTokenBinDataset:
    """The C++ mmap + gather loader, bitwise ``training/data.py``'s
    ``TokenBinDataset`` for every (seed, step) (and ``rows``). Raises
    ImportError when the native path is not live; ``make_fastest_dataset``
    falls back instead."""

    def __init__(self, path: str, seq_len: int, n_threads: int = 4):
        lib = _load()
        if lib is None:
            raise ImportError("the native runtime is not built (no g++)")
        dtype, self.vocab_size = _meta_dtype(path)
        self._lib = lib
        self._h = lib.orion_loader_open(path.encode(), seq_len, int(dtype.itemsize))
        if not self._h:
            raise OSError(f"orion_loader_open failed for {path}")
        self.path = path
        self.seq_len = seq_len
        self.n_threads = n_threads
        self.n_tokens = lib.orion_loader_n_tokens(self._h)
        self.n_windows = self.n_tokens - seq_len - 1
        if self.n_windows <= 0:
            self.close()
            raise ValueError(f"{path}: too few tokens for seq_len={seq_len}")

    def batch(self, seed: int, step: int, batch_size: int,
              rows: Optional[np.ndarray] = None) -> np.ndarray:
        """[B, seq_len+1] int32; a pure function of (seed, step). ``rows``:
        only those rows of it (their windows alone are read)."""
        if rows is not None:
            from orion_tpu_torch.training.data import window_starts

            return self.gather(window_starts(seed, step, batch_size, self.n_windows)[rows])
        out = np.empty((batch_size, self.seq_len + 1), dtype=np.int32)
        self._lib.orion_loader_batch(self._h, ctypes.c_uint64(seed), ctypes.c_uint64(step),
                                     batch_size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                     self.n_threads)
        return out

    def gather(self, starts: np.ndarray) -> np.ndarray:
        """[len(starts), seq_len+1] int32 windows at explicit offsets."""
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        out = np.empty((starts.size, self.seq_len + 1), dtype=np.int32)
        self._lib.orion_loader_gather(self._h, starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                      starts.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                      self.n_threads)
        return out

    def close(self):
        if self._h:
            self._lib.orion_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def make_fastest_dataset(path: str, seq_len: int):
    """The native loader when it is live, ``training/data.py``'s
    ``TokenBinDataset`` otherwise."""
    if native_available():
        return NativeTokenBinDataset(path, seq_len)
    from orion_tpu_torch.training.data import TokenBinDataset

    return TokenBinDataset(path, seq_len)


class NativeBPE:
    """The C++ BPE encoder (``bpe.cc``), token for token ``utils/bpe.py``'s
    Python encode; made from the tokenizer's merge list."""

    def __init__(self, merges):
        lib = _load()
        if lib is None:
            raise ImportError("the native runtime is not built (no g++)")
        flat = np.ascontiguousarray(np.asarray(merges, dtype=np.int32).reshape(-1))
        self._lib = lib
        self._h = lib.orion_bpe_create(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                       len(merges))
        if not self._h:
            raise OSError("orion_bpe_create failed")

    def encode(self, text: str):
        data = text.encode("utf-8")
        if not data:
            return []
        out = np.empty(len(data), dtype=np.int32)
        n = self._lib.orion_bpe_encode(self._h, data, len(data),
                                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out[:n].tolist()

    def __del__(self):
        try:
            if self._h:
                self._lib.orion_bpe_destroy(self._h)
                self._h = None
        except Exception:
            pass


class NativeCorpusGen:
    """The C++ interpolated-trigram sampler (``corpusgen.cc``), bitwise
    ``training/corpusgen.py``'s ``MarkovModel``."""

    def __init__(self, corpus: np.ndarray):
        lib = _load()
        if lib is None:
            raise ImportError("the native runtime is not built (no g++)")
        # the model keeps a pointer into this buffer: hold our own copy
        self._corpus = np.ascontiguousarray(corpus, dtype=np.uint16)
        self._lib = lib
        self._h = lib.orion_corpusgen_fit(
            self._corpus.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), self._corpus.size)
        if not self._h:
            raise OSError("orion_corpusgen_fit failed (needs >= 3 tokens)")

    def sample(self, seed: int, n_out: int, p_uni: float = 0.02,
               p_bi: float = 0.15) -> np.ndarray:
        out = np.empty(n_out, dtype=np.uint16)
        self._lib.orion_corpusgen_sample(self._h, ctypes.c_uint64(seed), p_uni, p_bi, n_out,
                                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
        return out

    def close(self):
        if self._h:
            self._lib.orion_corpusgen_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def byte_encode_file(in_path: str, out_path: str) -> int:
    """A raw file as a uint16 token-bin (+ sidecar), streamed natively when
    the native path is live, through numpy otherwise. Returns the token
    count."""
    lib = _load()
    if lib is not None:
        n = lib.orion_byte_encode_file(in_path.encode(), out_path.encode())
        if n < 0:
            raise OSError(f"orion_byte_encode_file failed: {in_path}")
    else:
        with open(in_path, "rb") as f:
            data = f.read()
        np.frombuffer(data, dtype=np.uint8).astype(np.uint16).tofile(out_path)
        n = len(data)
    with open(out_path + ".meta.json", "w") as f:
        json.dump({"dtype": "uint16", "count": int(n), "vocab_size": 256}, f)
    return int(n)


__all__ = [
    "build", "native_available", "NativeTokenBinDataset", "NativeBPE",
    "NativeCorpusGen", "make_fastest_dataset", "byte_encode_file",
]
