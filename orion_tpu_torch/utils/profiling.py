"""Profiling hooks: the port's counterpart of ``orion_tpu/utils/profiling.py``.

``trace(logdir)`` records a region with ``torch.profiler`` (CPU ops and, on
the card, CUDA kernels and copies) and writes a Chrome trace into
``logdir`` (load it in Perfetto or ``chrome://tracing``); ``annotate(name)``
names a sub-region in that trace; ``StepTimer`` gives host-side step wall
times and tokens/s percentiles without any device sync beyond what the
caller already does. :class:`Capture` is the start / stop form the Server's
on-demand ``/profilez`` capture drives from its scheduler thread.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"  # the Chrome trace a capture writes into its directory


class Capture:
    """One ``torch.profiler`` capture into ``logdir``: :meth:`start`, then
    :meth:`stop`, which writes ``logdir/trace.json`` and returns its path.
    ``cuda`` adds the CUDA activity (kernels, copies); by default when a
    card is available. Asking for it without a card raises: a trace that
    silently lacks the device would read as an idle one."""

    def __init__(self, logdir: str, cuda: Optional[bool] = None):
        if cuda is None:
            cuda = torch.cuda.is_available()
        if cuda and not torch.cuda.is_available():
            raise RuntimeError("a CUDA profile was asked for but torch.cuda.is_available() is "
                               "False")
        self.logdir = logdir
        self.stop_ms = self.export_ms = 0.0
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=activities)

    def start(self) -> None:
        os.makedirs(self.logdir, exist_ok=True)
        self._prof.start()

    def stop(self) -> str:
        """Stop and write the trace; ``stop_ms`` and ``export_ms`` record what
        each took on the host."""
        t0 = time.perf_counter()
        self._prof.stop()
        t1 = time.perf_counter()
        path = os.path.join(self.logdir, TRACE_FILE)
        self._prof.export_chrome_trace(path)
        self.stop_ms, self.export_ms = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
        return path


@contextlib.contextmanager
def trace(logdir: str, cuda: Optional[bool] = None):
    """Profile a region: ``with trace("/tmp/prof"): trainer.step(batch)``
    writes ``/tmp/prof/trace.json``."""
    cap = Capture(logdir, cuda=cuda)
    cap.start()
    try:
        yield cap
    finally:
        cap.stop()


def annotate(name: str):
    """A named sub-region inside a trace."""
    return record_function(name)


class StepTimer:
    """Host-side step timing; call mark() once per step (after any sync the
    loop already performs)."""

    def __init__(self, tokens_per_step: int = 0):
        self.tokens_per_step = tokens_per_step
        self._times: List[float] = []
        self._last: Optional[float] = None

    def mark(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        n = len(ts)
        out = {
            "steps": float(n),
            "p50_ms": 1000 * ts[n // 2],
            "p90_ms": 1000 * ts[min(n - 1, int(n * 0.9))],
            "mean_ms": 1000 * sum(ts) / n,
        }
        if self.tokens_per_step:
            out["tokens_per_sec"] = self.tokens_per_step / (sum(ts) / n)
        return out


__all__ = ["trace", "annotate", "StepTimer", "Capture", "TRACE_FILE"]
