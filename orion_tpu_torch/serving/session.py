"""DecodeSession: one request's chunked, fault-tolerant decode walk (the
port's counterpart of ``orion_tpu/serving/session.py``).

``generate`` decodes every token in one loop: a NaN in the recurrent state
poisons the rest with no point to observe it, and nothing on the host (a
deadline, a drain) can act until the end. The session decodes in bounded
chunks (``generate.decode_chunk``, the same step function: the same tokens
bitwise for the same seed) and uses each boundary:

- **snapshot** -- a copy of the decode state at the boundary
  (``snapshot_decode_state``): the rewind target. The chunk itself advances
  the caches and rings in place, so the snapshot must own its tensors, and
  no attempt is ever handed the snapshot itself: the first attempt runs on
  the live carry, every later one on a fresh copy of the snapshot, which
  therefore stays as it was through any number of attempts;
- **probe** -- the all-finite reduction over the state
  (``decode_state_finite``), read on the host: the one host sync of a chunk;
- **degradation ladder** -- on a non-finite state: (1) rewind to the
  snapshot and redo the chunk (clears a transient fault); (2) rebuild the
  state by re-prefilling the prompt and every token emitted so far (clears
  a poisoned snapshot); (3) fail the request with status ``"failed"``,
  never the process;
- **deadline** -- checked at each boundary against an injectable clock; an
  expired request returns its tokens so far with status ``"deadline"``;
- **fault hooks** -- ``fire("serve.chunk", step=chunk)`` at each boundary and
  the ``decode.state_nan`` marker consumed after each attempt
  (``resilience/inject.py``), so each rung is reachable on purpose.

Sampling keys: row b of a request of seed s draws with
``generate.request_keys(s, B)[b]``, as ``generate`` does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from orion_tpu_torch.generate import (SampleConfig, decode_chunk, prefill_carry,
                                      reprefill_carry, request_keys)
from orion_tpu_torch.models.transformer import decode_state_finite, snapshot_decode_state
from orion_tpu_torch.obs import flight
from orion_tpu_torch.resilience.inject import decode_nan_armed, fire

Tensor = torch.Tensor


class LadderExhausted(RuntimeError):
    """Every rung of the degradation ladder left a non-finite decode state;
    the request is failed (the process keeps serving)."""


@dataclasses.dataclass(frozen=True)
class DecodeRequest:
    """One generation request. ``prompt``: token ids, [T] or [B, T].
    ``deadline_ms`` <= 0 means no deadline. ``session_id`` makes the request
    a durable-session turn: ``SlotEngine`` suspends its slot at its end and
    hands its state out on the result (``DecodeResult.session``), and
    ``SlotEngine.resume`` continues it bitwise; through the Server, a known
    id with an empty prompt resumes the conversation, with new tokens it
    re-prefills the whole history first.

    ``prefix_len`` declares the first ``prefix_len`` prompt tokens a SHARED,
    cacheable prefix (a system prompt): with a prefix store, a miss publishes
    the aligned prefix's state so later requests admit at O(suffix). Lookups
    run for every request; the declaration only gates publishing. 0 = no
    declaration."""

    prompt: Any
    max_new_tokens: int
    sample: SampleConfig = SampleConfig()
    seed: int = 0
    deadline_ms: float = 0.0
    session_id: Optional[str] = None
    prefix_len: int = 0


@dataclasses.dataclass
class DecodeResult:
    tokens: np.ndarray  # [B, new_tokens]
    status: str  # "ok" | "deadline" | "failed" | "suspended"
    new_tokens: int
    chunks: int
    rewinds: int = 0
    reprefills: int = 0
    # cost attribution (the Server's batched path only; a solo DecodeSession
    # reports zeros): this request's share of the measured chunk wall time
    # (the co-residents' shares sum to the boundary's chunk_ms), the flops
    # billed for it, and the prefill / decode tokens behind them
    device_ms: float = 0.0
    cost_flops: float = 0.0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    # the suspended SessionState riding out of SlotEngine for the caller to
    # persist before it releases the result (durable sessions only)
    session: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def degraded(self) -> bool:
        """Did the request need the degradation ladder to complete?"""
        return self.rewinds > 0 or self.reprefills > 0


@torch.inference_mode()
def _poison_states(states) -> None:
    """NaN-fill every floating leaf of the decode state in place: the
    injected fault's effect."""
    for st in states:
        for x in st.values():
            if x.is_floating_point():
                x.fill_(float("nan"))


def _with_states(carry, states):
    return (carry[0], states, *carry[2:])


class DecodeSession:
    """Chunked decode with snapshots, the finite probe and the degradation
    ladder. One session serves many requests; it owns no thread and
    installs no handler."""

    def __init__(self, model, *, chunk: int = 16,
                 clock: Callable[[], float] = time.monotonic):
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.model = model
        self.chunk = int(chunk)
        self._clock = clock

    def _probe_finite(self, carry) -> bool:
        """The designated host sync of the decode loop: one bool a chunk."""
        return bool(decode_state_finite(carry[1]))

    def _attempt(self, carry, keys, start, n_steps, sample, chunk_idx):
        """One chunk attempt from ``carry`` (its states advanced in place);
        consumes an armed decode-state NaN fault afterwards, so a
        multi-delivery plan poisons each rung's attempt in turn."""
        carry, toks = decode_chunk(self.model, carry, keys, start, n_steps, sample)
        if decode_nan_armed(chunk_idx):
            _poison_states(carry[1])
        return carry, toks

    def _chunk_with_ladder(self, prompt, emitted, carry, snap, keys, n, n_steps, sample,
                           chunk_idx):
        """Advance one chunk from ``carry`` (whose states equal ``snap``'s
        and are not ``snap``'s tensors), walking the ladder on a non-finite
        state. -> (carry, tokens, rewinds, reprefills), or raises
        :class:`LadderExhausted`."""
        carry, toks = self._attempt(carry, keys, n, n_steps, sample, chunk_idx)
        if self._probe_finite(carry):
            return carry, toks, 0, 0
        # rung 1: redo the chunk from a fresh copy of the boundary snapshot
        flight.record("ladder", rung="rewind", chunk=chunk_idx)
        redo = _with_states(snap, snapshot_decode_state(snap[1]))
        carry, toks = self._attempt(redo, keys, n, n_steps, sample, chunk_idx)
        if self._probe_finite(carry):
            return carry, toks, 1, 0
        # rung 2: the snapshot itself may be poisoned: rebuild the state
        # from the tokens, the one thing known good
        flight.record("ladder", rung="reprefill", chunk=chunk_idx)
        fresh = reprefill_carry(self.model, prompt, emitted, sample, keys)
        carry, toks = self._attempt(fresh, keys, n, n_steps, sample, chunk_idx)
        if self._probe_finite(carry):
            return carry, toks, 1, 1
        flight.record("ladder", rung="exhausted", chunk=chunk_idx)
        raise LadderExhausted(
            f"decode state non-finite at chunk {chunk_idx} after rewind and re-prefill; "
            "failing the request"
        )

    @torch.inference_mode()
    def run(self, request: DecodeRequest, on_chunk: Optional[Callable[[int], None]] = None,
            deadline_at: Optional[float] = None) -> DecodeResult:
        """Serve one request. ``on_chunk(chunk_idx)`` runs at every chunk
        boundary. Decode-state faults and deadlines come back as the
        result's ``status``; only bad arguments raise. ``deadline_at``: an
        absolute clock value that overrides the request's relative
        ``deadline_ms``."""
        dev = self.model.device
        prompt = torch.as_tensor(request.prompt, device=dev).long()
        if prompt.dim() == 1:
            prompt = prompt[None]
        cap = self.model.cfg.max_seq_len
        if prompt.shape[1] + request.max_new_tokens > cap:
            raise ValueError(f"prompt {prompt.shape[1]} + new {request.max_new_tokens} "
                             f"exceeds max_seq_len {cap}")
        sample = request.sample
        keys = request_keys(request.seed, prompt.shape[0], dev)
        if deadline_at is not None:
            deadline = deadline_at
        elif request.deadline_ms > 0:
            deadline = self._clock() + request.deadline_ms / 1000.0
        else:
            deadline = None
        if deadline is not None and self._clock() >= deadline:
            # expired before it started: not even the prefill
            return DecodeResult(tokens=np.zeros((prompt.shape[0], 0), np.int64),
                                status="deadline", new_tokens=0, chunks=0)
        carry = prefill_carry(self.model, prompt, sample, keys)
        emitted: List[Tensor] = []
        n = chunk_idx = rewinds = reprefills = 0
        status = "ok"
        while n < request.max_new_tokens:
            fire("serve.chunk", step=chunk_idx)
            if on_chunk is not None:
                on_chunk(chunk_idx)
            if deadline is not None and self._clock() >= deadline:
                status = "deadline"
                break
            n_steps = min(self.chunk, request.max_new_tokens - n)
            snap = _with_states(carry, snapshot_decode_state(carry[1]))
            try:
                carry, toks, r, rp = self._chunk_with_ladder(
                    prompt, emitted, carry, snap, keys, n, n_steps, sample, chunk_idx)
            except LadderExhausted:
                status = "failed"
                break
            rewinds += r
            reprefills += rp
            emitted.append(toks)
            n += n_steps
            chunk_idx += 1
        tokens = (torch.cat(emitted, dim=1).cpu().numpy() if emitted
                  else np.zeros((prompt.shape[0], 0), np.int64))
        return DecodeResult(tokens=tokens, status=status, new_tokens=n, chunks=chunk_idx,
                            rewinds=rewinds, reprefills=reprefills)


__all__ = ["DecodeRequest", "DecodeResult", "DecodeSession", "LadderExhausted"]
