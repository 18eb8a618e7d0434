"""Data pipeline: token-bin datasets, deterministic window sampling, and a
threaded host-to-device prefetch.

The port's counterpart of ``orion_tpu/training/data.py``. The datasets are
numpy and copy the reference's sampling exactly (``window_starts``'
splitmix64 stream, ``SyntheticDataset``'s Philox draws), so a batch is
bitwise the reference's for the same (seed, step). The on-disk format is a
flat binary of token ids (uint16/uint32) with a JSON sidecar
(``<name>.meta.json``: {"dtype", "count", "vocab_size"}), mmap'd on the
host. Sampling is a pure function of (seed, step): resuming at step N
reproduces the batch sequence with no iterator state to checkpoint.

On a data mesh a rank reads only its rows (``rows``: the global row indices
``parallel.mesh.Mesh.row_index`` gives): a token-bin dataset gathers just
their windows, at their global window starts, so they are bitwise those
rows of the global batch.

A token-bin path takes the native loader (``runtime/loader.cc`` through
``orion_tpu_torch.runtime``, built with g++ at first use) when it is
available, and this module's numpy twin otherwise: the two are batch for
batch bitwise (``tests/test_torch_runtime.py``). The prefetch worker retries
a transient ``OSError`` of the dataset read with jittered backoff (firing the
``data.batch`` fault hook inside the retried region), a worker that dies
anyway re-raises its exception as the ``__cause__`` of a ``RuntimeError``
from ``__next__``, and ``stall_timeout`` turns a consumer that would wait for
ever on a hung read into a :class:`~orion_tpu_torch.resilience.watchdog.StallError`.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from orion_tpu_torch.resilience.inject import fire
from orion_tpu_torch.resilience.retry import RetryPolicy, call_with_retries
from orion_tpu_torch.resilience.watchdog import StallError
from orion_tpu_torch.training.checkpoint import atomic_write_json

_SM64_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM64_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM64_M2 = np.uint64(0x94D049BB133111EB)
_STEP_MIX = np.uint64(0xD1B54A32D192ED03)
_ROW_MIX = np.uint64(0x8CB92BA72F3D8DD7)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (the sampler hash, mirrored bit for
    bit by ``runtime/loader.cc`` and ``runtime/corpusgen.cc``)."""
    with np.errstate(over="ignore"):
        z = x + _SM64_GAMMA
        z = (z ^ (z >> np.uint64(30))) * _SM64_M1
        z = (z ^ (z >> np.uint64(27))) * _SM64_M2
        return z ^ (z >> np.uint64(31))


def window_starts(seed: int, step: int, batch_size: int, n_windows: int) -> np.ndarray:
    """Deterministic window start offsets for (seed, step)."""
    rows = np.arange(batch_size, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = np.uint64(seed) ^ (np.uint64(step) * _STEP_MIX) ^ (rows * _ROW_MIX)
    return (_splitmix64(x) % np.uint64(n_windows)).astype(np.int64)


def write_token_bin(path: str, tokens: np.ndarray, vocab_size: int) -> None:
    """Write the token-bin format (+ sidecar, published atomically)."""
    dtype = np.uint16 if vocab_size <= 65536 else np.uint32
    arr = np.asarray(tokens, dtype=dtype)
    arr.tofile(path)
    atomic_write_json(
        path + ".meta.json",
        {"dtype": np.dtype(dtype).name, "count": int(arr.size), "vocab_size": int(vocab_size)},
    )


class TokenBinDataset:
    """mmap'd flat token file; windows of seq_len+1 sampled deterministically."""

    def __init__(self, path: str, seq_len: int):
        meta_path = path + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            dtype = np.dtype(meta["dtype"])
            self.vocab_size = int(meta.get("vocab_size", np.iinfo(dtype).max + 1))
        else:
            dtype = np.dtype(np.uint16)
            self.vocab_size = 65536
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.n_windows = len(self.tokens) - seq_len - 1
        if self.n_windows <= 0:
            raise ValueError(f"{path}: too few tokens for seq_len={seq_len}")

    def batch(self, seed: int, step: int, batch_size: int,
              rows: Optional[np.ndarray] = None) -> np.ndarray:
        """[B, seq_len+1] int32; a pure function of (seed, step). ``rows``:
        only those rows of it (their windows alone are read)."""
        starts = window_starts(seed, step, batch_size, self.n_windows)
        return self.gather(starts if rows is None else starts[rows])

    def gather(self, starts: np.ndarray) -> np.ndarray:
        """[len(starts), seq_len+1] int32 windows at explicit offsets."""
        out = np.empty((len(starts), self.seq_len + 1), dtype=np.int32)
        for i, s in enumerate(starts):
            out[i] = self.tokens[s : s + self.seq_len + 1]
        return out


class ShardedTokenBinDataset:
    """Many token-bin shards as one virtual corpus: the window space is the
    concatenation of each shard's windows, and a global start from
    ``window_starts`` maps to (shard, local offset), so windows never span
    shards and the (seed, step) -> batch contract is the single-file one
    with ``n_windows = sum of the shards'``."""

    def __init__(self, paths, seq_len: int):
        if not paths:
            raise ValueError("ShardedTokenBinDataset needs at least one shard")
        from orion_tpu_torch import runtime

        self.paths = list(paths)
        self.seq_len = seq_len
        # each shard's gathers ride the native loader when it is built
        self.shards = [runtime.make_fastest_dataset(p, seq_len) for p in self.paths]
        vocabs = {s.vocab_size for s in self.shards}
        if len(vocabs) != 1:
            raise ValueError(f"shards disagree on vocab_size: {sorted(vocabs)}")
        self.vocab_size = vocabs.pop()
        per = np.asarray([s.n_windows for s in self.shards], dtype=np.int64)
        if not (per > 0).all():
            raise ValueError(f"every shard must hold more than seq_len + 1 = {seq_len + 1} tokens")
        self._cum = np.cumsum(per)
        self.n_windows = int(self._cum[-1])

    def batch(self, seed: int, step: int, batch_size: int,
              rows: Optional[np.ndarray] = None) -> np.ndarray:
        starts = window_starts(seed, step, batch_size, self.n_windows)
        if rows is not None:
            starts = starts[rows]
        which = np.searchsorted(self._cum, starts, side="right")
        local = starts - np.concatenate([[0], self._cum[:-1]])[which]
        out = np.empty((len(starts), self.seq_len + 1), dtype=np.int32)
        for si in np.unique(which):
            rows = np.nonzero(which == si)[0]
            out[rows] = self.shards[si].gather(local[rows])
        return out


class SyntheticDataset:
    """Deterministic pseudo-data with learnable structure (each token is a
    fixed function of the previous two), the same ``batch(seed, step, b)``
    interface as TokenBinDataset."""

    def __init__(self, vocab_size: int, seq_len: int):
        self.vocab_size = vocab_size
        self.seq_len = seq_len

    def batch(self, seed: int, step: int, batch_size: int,
              rows: Optional[np.ndarray] = None) -> np.ndarray:
        """``rows``: only those rows (the whole batch is drawn: each row's
        first two tokens come from one stream)."""
        if rows is not None:
            return self.batch(seed, step, batch_size)[rows]
        rng = np.random.Generator(np.random.Philox(key=[seed, step]))
        t = self.seq_len + 1
        out = np.empty((batch_size, t), dtype=np.int32)
        out[:, 0] = rng.integers(0, self.vocab_size, size=batch_size)
        out[:, 1] = rng.integers(0, self.vocab_size, size=batch_size)
        for j in range(2, t):
            out[:, j] = (out[:, j - 1] * 31 + out[:, j - 2] * 7 + 3) % self.vocab_size
        return out


def _host_batch(dataset, seed: int, step: int, batch_size: int,
               rows: Optional[np.ndarray] = None) -> np.ndarray:
    """``dataset.batch(seed, step, batch_size)``, its ``rows`` only when
    given."""
    if rows is None:
        return dataset.batch(seed, step, batch_size)
    return dataset.batch(seed, step, batch_size, rows=rows)


def _device_copy(host: np.ndarray, device) -> torch.Tensor:
    """A host batch as an int64 tensor on ``device`` (through pinned memory
    to a card)."""
    t = torch.from_numpy(host)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, torch.int64, non_blocking=True)
    return t.to(torch.int64)


def device_batch(dataset, seed: int, step: int, batch_size: int, device,
                 rows: Optional[np.ndarray] = None) -> torch.Tensor:
    """``dataset.batch(seed, step, batch_size)`` (its ``rows`` only, when
    given) as an int64 tensor on ``device``."""
    return _device_copy(_host_batch(dataset, seed, step, batch_size, rows), device)


class DataLoader:
    """Background-thread prefetch: ``dataset.batch`` for steps
    ``start_step, start_step + 1, ...``, copied to ``device`` as int64,
    ``prefetch`` batches deep. Restart-safe: batches are pure functions of
    (seed, step). ``rows``: only those rows of each batch (a data rank's,
    ``Mesh.row_index``).

    Resilience, as the JAX package's loader: a transient ``OSError`` of the
    read retries under ``retry`` (default 3 attempts, 0.05 s base delay,
    1 s at most), with the ``data.batch`` hook fired inside; a worker that
    dies anyway re-raises from ``__next__`` as ``RuntimeError("data prefetch
    thread died ...")`` with the original exception as ``__cause__``; with
    ``stall_timeout`` a consumer that waits longer than that for a batch
    gets a :class:`StallError` naming the step the worker is stuck on."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, start_step: int = 0,
                 device=None, prefetch: int = 2, rows: Optional[np.ndarray] = None,
                 stall_timeout: Optional[float] = None, retry: Optional[RetryPolicy] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = rows
        self.seed = seed
        self.step = start_step
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.stall_timeout = stall_timeout
        self._retry = (retry if retry is not None
                       else RetryPolicy(attempts=3, base_delay=0.05, max_delay=1.0))
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._fetch_step = start_step  # the step the worker is on (the diagnosis)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            self._worker_loop()
        except BaseException as e:  # kept for __next__ to chain, traceback intact
            self._exc = e

    def _worker_loop(self):
        step = self.step
        while not self._stop.is_set():
            self._fetch_step = step

            def fetch(step=step):
                fire("data.batch", step=step)
                return _host_batch(self.dataset, self.seed, step, self.batch_size, self.rows)

            host = call_with_retries(fetch, self._retry, describe=f"data batch fetch (step {step})")
            batch = _device_copy(host, self.device)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[torch.Tensor]:
        return self

    def __next__(self) -> torch.Tensor:
        deadline = time.monotonic() + self.stall_timeout if self.stall_timeout else None
        while True:
            wait = 1.0
            if deadline is not None:
                wait = max(0.02, min(1.0, deadline - time.monotonic()))
            try:
                return self._q.get(timeout=wait)
            except queue.Empty:
                if self._exc is not None or not self._thread.is_alive():
                    raise RuntimeError(
                        f"data prefetch thread died at step {self._fetch_step}") from self._exc
                if deadline is not None and time.monotonic() >= deadline:
                    raise StallError(
                        f"data loader stalled: no batch for {self.stall_timeout:.1f}s (prefetch "
                        f"worker alive but stuck fetching step {self._fetch_step} -- hung "
                        "dataset read?)")

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def make_dataset(spec: str, seq_len: int, vocab_size: Optional[int] = None):
    """'synthetic', a token-bin path, a directory of ``shard_*.bin`` (the
    layout ``training/corpusgen.py`` writes), or a comma-separated shard
    list. Token-bin files take the native loader when it is built
    (``runtime.make_fastest_dataset``), bitwise the numpy twin."""
    if spec == "synthetic":
        return SyntheticDataset(vocab_size or 256, seq_len)
    if "," in spec:
        return ShardedTokenBinDataset([p for p in spec.split(",") if p], seq_len)
    if os.path.isdir(spec):
        paths = sorted(glob.glob(os.path.join(spec, "shard_*.bin")))
        if not paths:
            raise ValueError(f"{spec}: no shard_*.bin files (the corpusgen layout)")
        return ShardedTokenBinDataset(paths, seq_len)
    from orion_tpu_torch import runtime

    return runtime.make_fastest_dataset(spec, seq_len)


__all__ = [
    "TokenBinDataset", "ShardedTokenBinDataset", "SyntheticDataset", "DataLoader",
    "write_token_bin", "make_dataset", "window_starts", "device_batch",
]
