"""Durable sessions' state: the port's counterpart of the ``SessionState``
of ``orion_tpu/serving/session_store.py``, with its fields as numpy arrays
and torch tensors on the host.

``SlotEngine`` hands one out when it suspends a session's slot, and
``SlotEngine.resume`` takes it back. ``SessionStore`` itself (the
generation-numbered files, their manifests and checksums, the retried
reads and writes) is ROADMAP.md's A8 step 3 and not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np


@dataclasses.dataclass
class SessionState:
    """One suspended conversation: the slot's carry row, copied to the host,
    and what a resume needs beside it.

    - ``token`` / ``state`` / ``t`` / ``emit`` / ``done`` -- the batch-1
      carry row as extracted at a chunk boundary (``state``: the per-layer
      decode state, dicts of CPU tensors); ``emit`` is the index of the
      last token the row drew, its key's fold, so a resume at ``emit``
      draws the uninterrupted walk's tokens;
    - ``prompt`` -- the context the state was built from; the ladder's
      re-prefill rung rebuilds from ``prompt`` + ``emitted``;
    - ``emitted`` -- every token the carry emitted since ``prompt``, the
      last chunk's overshoot included; ``served`` counts those returned to
      the client, and a continuation serves ``emitted[served:]`` first,
      which keeps several turns bitwise one uninterrupted request;
    - ``seed`` / ``sample`` -- the request seed whose key the walk folds,
      and its ``SampleConfig`` (a continuation must match it).
    """

    session_id: str
    seed: int
    sample: Any  # generate.SampleConfig
    served: int
    token: np.ndarray  # [1] int64
    state: List[Dict[str, Any]]  # per-layer decode state, batch 1, CPU tensors
    t: np.ndarray  # [] int64: the sequence position
    emit: np.ndarray  # [] int64: the key fold
    done: np.ndarray  # [1] bool
    prompt: np.ndarray  # [1, T] int64
    emitted: np.ndarray  # [1, n] int64
    generation: int = 0  # the store's, once it saves or loads one

    @property
    def buffered(self) -> int:
        """Emitted-but-unserved tokens a continuation serves first."""
        return max(int(self.emitted.shape[1]) - int(self.served), 0)


__all__ = ["SessionState"]
