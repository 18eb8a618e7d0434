"""Builds and loads the kernel libraries of ``csrc/``.

Each source is compiled on its own with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``orion_tpu_torch/_build/`` under a name carrying a hash of the source and
of the headers it includes (``csrc/hopper.cuh``; an edit of either is
rebuilt), and loaded with ``ctypes``. The kernel wrappers
(``causal_dot.py``, ``flash_attention.py``) keep their own ``SOURCES`` and
call signatures; nothing here touches CUDA while the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the kernels build on the card's host")


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _headers(source: Path) -> List[Path]:
    """The headers ``source`` includes with quotes, and theirs, in the order
    nvcc finds them: beside the including file first, then in ``CSRC`` (the
    ``-I`` of the build)."""
    found: List[Path] = []
    todo = [source]
    while todo:
        including = todo.pop()
        for name in _INCLUDE.findall(including.read_text()):
            for cand in (including.parent / name, CSRC / name):
                if cand.exists():
                    if cand not in found:
                        found.append(cand)
                        todo.append(cand)
                    break
            else:
                raise FileNotFoundError(f"{source}: included header {name!r} not found")
    return found


def _library_path(source: Path) -> Path:
    """The library's path: the source's name and a hash of the source
    together with every header it includes, so an edit of either rebuilds."""
    h = hashlib.sha256(source.read_bytes())
    for header in _headers(source):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def _build_command(source: Path, out: Path) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
        "-o", str(out), str(source),
    ]


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` into a library if it has no build yet. Returns
    (path, compiler output); the output is empty when the build already
    existed. Writes to a temporary name and renames, so concurrent builds
    are safe."""
    path = _library_path(source)
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            _build_command(source, Path(tmp)), capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, proc.stdout + proc.stderr


def load(source: Path, signatures: Dict[str, List]):
    """Build ``source`` if needed and load it, with each C function of
    ``signatures`` (name -> ctypes argument types) returning a C int."""
    path, _ = build(source)
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream(device) -> int:
    """The current CUDA stream of ``device``, as the int a C function takes."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_if_grad(tensors, via: str) -> None:
    """Refuse a bare kernel launch on an input that requires grad while grad
    is enabled: the outputs would carry none. ``via`` names the path whose
    backward runs the backward kernels."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in tensors):
        raise RuntimeError(
            "a CUDA kernel's output carries no gradient: call the kernel with grad "
            f"disabled, or go through {via}, whose backward runs the backward kernels"
        )


def check_launch(fn_name: str, acts, fp32s) -> None:
    """Checks every kernel wrapper makes before a launch: ``acts`` (the
    activations) share bf16 or fp32, ``fp32s`` (states, row statistics; None
    for absent ones) are fp32, all lie on one CUDA device, all contiguous."""
    fp32s = [x for x in fp32s if x is not None]
    tensors = list(acts) + fp32s
    first = tensors[0]
    if first.device.type != "cuda":
        raise RuntimeError(
            f"{fn_name} needs CUDA tensors; got {first.device} "
            "(backend='torch' runs the plain version anywhere)"
        )
    if any(x.device != first.device for x in tensors):
        raise ValueError("all inputs must lie on one device")
    dt = acts[0].dtype
    if dt not in (torch.bfloat16, torch.float32) or any(x.dtype != dt for x in acts):
        raise TypeError(
            f"{fn_name}: the activations must share dtype bf16 or fp32; got "
            f"{[x.dtype for x in acts]}"
        )
    if any(x.dtype != torch.float32 for x in fp32s):
        raise TypeError(f"{fn_name}: states and row statistics must be float32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("inputs must be contiguous")


__all__ = ["BUILD_DIR", "CSRC", "build", "check_launch", "load", "raise_if_grad", "stream"]
