"""SlotEngine: slot-multiplexed continuous batching of the decode path (the
port's counterpart of ``orion_tpu/serving/batching.py``).

Every request's decode state is O(1) (an (S, z) per linear layer, a KV cache
or a ring per softmax / swa layer), so a "slot" is one row of a batched
carry and Orca-style iteration-level scheduling is row inserts and row
evictions on it. The engine drives ``generate.py``'s slot programs:

- **slots** -- a fixed number of rows share one carry (next token [S],
  states, position t [S], emitted-token index [S], done [S]) and one
  program per boundary: ``decode_batched_chunk`` while every busy slot
  decodes, ``decode_batched_prefill_chunk`` while one is still consuming its
  prompt. Each slot samples with its request's counter key
  (``generate.request_keys(seed, 1)``), folded by the slot's emitted-token
  index, so a request draws what a one-row ``generate`` at its seed draws.
- **admission** -- at chunk boundaries. ``prefill_chunk=0``: the prompt is
  prefilled solo on the host thread (``prefill_carry``, right-padded to its
  bucket) and its carry row-written (``insert_decode_slot``). In-scan
  (``prefill_chunk > 0``): the prompt is staged into a [slots, bucket]
  buffer and consumed ``prefill_chunk`` tokens a boundary, as a piece of the
  unified program, by one slot at a time (least prompt left first); piece
  boundaries fall on the linear-attention chunk, so the slot reaches the
  carry the host prefill builds.
- **eviction** -- at the boundary where a request has its tokens, emitted
  EOS (the tail is PAD, filled on the host, as the solo walk emits it) or
  passed its deadline. A freed row rides on in the batch: it emits PAD and
  keeps its state bitwise (the programs' per-row ``write`` mask).
- **per-slot ladder** -- one host read an attempt: a [2, slots] bool of
  the per-row finite probe (``decode_state_finite_per_slot``) and the done
  flags. A slot whose state is not finite walks the ladder alone: rewind
  (redo the boundary from its snapshot; the other rows recompute the same
  tokens bitwise), then rebuild it from prompt + emitted tokens
  (``reprefill_carry``; a slot still mid-prefill restarts its in-scan
  prefill from a zero row), then fail that request while the others go on.
- **snapshots** -- the programs write the caches and rings in place, so the
  boundary snapshot is a copy of the carry that no attempt is handed: the
  first attempt runs on the live carry, each later one on a fresh copy of
  the snapshot.
- **sessions** -- a slot tagged with a ``session_id`` is suspended at its
  end (its carry row, prompt and emitted tokens as a ``SessionState``);
  ``resume`` row-writes it back at its position and key fold, so two turns
  emit what one uninterrupted request would.
- **prefix cache** -- with a ``PrefixStore`` attached (in-scan only), an
  admission looks its prompt up by content: a hit stages the cached row at
  the prefix's position with the whole prompt staged, so the pieces consume
  only the suffix (O(suffix) admission); a miss on a request that declares
  ``prefix_len`` queues the aligned prefix, and ``publish_pending_prefixes``
  (called between boundaries) prefills it solo and hands the state to the
  store. The lookup is hashing and disk on the host; the hit's row goes to
  the card as pinned asynchronous copies; the store reads the card once a
  novel prefix, in the publish.

Every op of a slot's row is row-wise, and a decode step's products run at
one row count (``models/transformer.py``'s ``decode_rows``), so a request's
tokens are bitwise the same at any slot count up to 64 and in any company
as in a one-row ``generate`` at its seed.

The engine owns no thread and installs no handler; it reads the card once
an attempt (the probe) and once a request (its tokens, at eviction).

The engine serves whatever model it is handed, quantized (``generate.
quantize_for_decode``) or not: every contract above holds per qmode.

Left out, each with the ROADMAP.md item that brings it: the executable store
(``attach_exec_store``, ``_warm_*``: A13);
speculation (``spec_depth``, ``_update_spec_accept``, ``spec_info``: A8
step 4); meshes and their exec lock (``mesh``, ``_TP_EXEC_LOCK``,
``_serialized``: A12); the compile bookkeeping (``_compile_seen``: A9 / A13;
eager torch compiles nothing).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from orion_tpu_torch.generate import (SampleConfig, bucket_for, decode_batched_chunk,
                                      decode_batched_prefill_chunk, prefill_carry,
                                      reprefill_carry, request_keys)
from orion_tpu_torch.models.transformer import (DECODE_ROWS, decode_state_finite_per_slot,
                                                extract_decode_slot, init_decode_state,
                                                insert_decode_slot, snapshot_decode_state)
from orion_tpu_torch.ops.dispatch import DEFAULT_CHUNK, resolve, resolve_chunk
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.resilience.breaker import StoreUnavailableError
from orion_tpu_torch.serving.session import DecodeRequest, DecodeResult
from orion_tpu_torch.serving.session_store import SessionState
from orion_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


def _host_to(x, device: torch.device, dtype=None) -> Tensor:
    """A host array on ``device`` without waiting for the card: pinned and
    copied asynchronously (a pageable copy would wait for the stream)."""
    x = torch.as_tensor(x, dtype=dtype)
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def _key_row(seed: int) -> List[int]:
    """The two words of a one-row request's counter key (``request_keys(seed,
    1)[0]``), computed on the host: written into the device's key table as
    scalars, with no copy to wait on."""
    return request_keys(seed, 1).tolist()[0]


def _zero_row(states, i: int) -> None:
    for st in states:
        for x in st.values():
            x[i].zero_()


def _insert_carry(carry, keys, plen, pfold, sub_carry, key: List[int], i: int,
                  n_emitted: int) -> None:
    """Row-write one solo carry (batch 1: token [1], states, t, done [1]) and
    its key into slot ``i``, in place. The slot's staged length is zeroed:
    a row inserted ready is past its prompt, so the unified program never
    treats it as prefilling. ``n_emitted`` is the fold of the next token it
    draws."""
    token, states, t, emit, done = carry
    tok1, st1, t1, done1 = sub_carry
    token[i] = tok1[0]
    insert_decode_slot(states, st1, i)
    t[i] = t1
    emit[i] = n_emitted
    done[i] = done1[0]
    keys[i, 0], keys[i, 1] = key
    plen[i] = 0
    pfold[i] = n_emitted


def _stage_prompt_carry(carry, keys, plen, pfold, pbuf, row: Tensor, key: List[int], i: int,
                        length: int, fold: int) -> None:
    """In-scan admission of slot ``i``, in place: its state row zeroed, its
    position 0, and its padded prompt ``row`` parked in the staging buffer;
    no prefill runs here. The unified program draws its first token at
    ``fold``."""
    token, states, t, emit, done = carry
    _zero_row(states, i)
    token[i] = 0
    t[i] = 0
    emit[i] = fold
    done[i] = False
    keys[i, 0], keys[i, 1] = key
    plen[i] = length
    pfold[i] = fold
    pbuf[i] = row


def _stage_prefix_carry(carry, keys, plen, pfold, pbuf, st1, row: Tensor, key: List[int], i: int,
                        length: int, fold: int, t0: int) -> None:
    """In-scan admission of slot ``i`` on a prefix-cache hit, in place: the
    cached prefix's state row ``st1`` (batch 1) at position ``t0 =
    len(prefix)``, the WHOLE padded prompt parked in the staging buffer and
    ``plen`` its whole length, so the unified program consumes from ``t0``:
    exactly the uncached suffix."""
    token, states, t, emit, done = carry
    insert_decode_slot(states, st1, i)
    token[i] = 0
    t[i] = t0
    emit[i] = fold
    done[i] = False
    keys[i, 0], keys[i, 1] = key
    plen[i] = length
    pfold[i] = fold
    pbuf[i] = row


def _host_tokens(prompt) -> np.ndarray:
    """A request's prompt as host token ids [1, T] (the Server hands host
    arrays; a tensor on the card would be read here)."""
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu()
    return np.asarray(prompt).reshape(1, -1)


def _restart_prefill_row(carry, i: int) -> None:
    """Ladder rung 2 for a slot still mid-prefill, in place: its state row
    zeroed and its position 0, so the in-scan prefill replays from the
    staged prompt (the one known-good input, left as it is)."""
    token, states, t, emit, done = carry
    _zero_row(states, i)
    token[i] = 0
    t[i] = 0
    done[i] = False


def _extract_carry(carry, i: int):
    """Slot ``i``'s row as the batch-1 carry ``_insert_carry`` takes, copied:
    (token [1], states, t [], emit [], done [1])."""
    token, states, t, emit, done = carry
    return (token[i:i + 1].clone(), extract_decode_slot(states, i), t[i].clone(),
            emit[i].clone(), done[i:i + 1].clone())


def _copy_carry(carry):
    """A copy of the carry that shares no tensor with it."""
    token, states, t, emit, done = carry
    return (token.clone(), snapshot_decode_state(states), t.clone(), emit.clone(), done.clone())


def parse_buckets(spec: str, max_seq_len: int) -> Tuple[int, ...]:
    """``--prefill-buckets`` spec -> sorted bucket lengths. ``"pow2"``:
    powers of two from 16 up to max_seq_len; ``"a,b,c"``: explicit;
    ``""`` / ``"off"``: none (each prompt prefilled at its own length)."""
    if not spec or spec == "off":
        return ()
    if spec == "pow2":
        out, b = [], 16
        while b < max_seq_len:
            out.append(b)
            b *= 2
        out.append(max_seq_len)
        return tuple(out)
    buckets = sorted({int(x) for x in spec.split(",") if x.strip()})
    if any(b <= 0 or b > max_seq_len for b in buckets):
        raise ValueError(f"prefill buckets must be in (0, max_seq_len={max_seq_len}]: {buckets}")
    return tuple(buckets)


@dataclasses.dataclass
class _Slot:
    """Host-side bookkeeping for one resident request."""

    request: DecodeRequest
    tag: Any
    deadline_at: Optional[float]
    prompt: Tensor  # [1, T] on the device (kept for the re-prefill rung)
    # per boundary (tokens [S, chunk] on the device, my row, valid count):
    # the row is read at eviction, not at the boundary (a read a boundary
    # would wait for the card at every chunk)
    toks: List[Tuple[Tensor, int, int]]
    n_emitted: int = 0
    chunks: int = 0  # request-local chunk index (the fault hooks' address)
    # prompt tokens the in-scan prefill has yet to consume (0: decoding;
    # always 0 for host-prefill admissions): the host mirror of the
    # device's plen - t, so no read-back says when a slot starts emitting
    prompt_remaining: int = 0
    rewinds: int = 0
    reprefills: int = 0
    # -- durable sessions (inert for requests without a session) --
    session_id: Optional[str] = None
    seed: int = 0  # the request key the slot's tokens are drawn with
    # tokens emitted between ``prompt`` and this turn's insert (the
    # re-prefill rung needs the whole history, not this turn's chunks)
    prior: List[np.ndarray] = dataclasses.field(default_factory=list)
    # emitted-but-unserved tokens of the suspended carry's last chunk: a
    # continuation serves them before decoding, which keeps turn
    # boundaries bitwise transparent
    prefix: Optional[np.ndarray] = None
    target_new: int = 0  # device tokens to decode this turn
    # the carry's emitted-token index at this turn's insert: fold_base +
    # n_emitted is the fold at any later boundary
    fold_base: int = 0
    served_base: int = 0  # session.served at resume (0 for fresh turns)


class SlotEngine:
    """Fixed-slot batched decode engine. One engine serves many requests
    over its lifetime; the resident requests share one ``SampleConfig``
    (the programs sample every row with it), so a request with another is
    refused at admission.

    ``slots`` is at most ``DECODE_ROWS`` (64): the row count a decode
    step pads its products to, which keeps batched == solo bitwise (C1).
    ``device``: where the carry lives (default ``"cuda"``; the model must
    be there too). ``prefill_chunk > 0`` admits in-scan and needs
    ``prefill_buckets``; it is rounded up to the linear-attention chunk the
    prefill runs at (the kernel's on the card, ``cfg.chunk`` on the CPU).
    ``prompt_overflow``: a prompt past the largest bucket is refused
    (``"error"``) or cut to its newest tokens (``"clamp"``). ``on_event(kind,
    fields)``: a host-only telemetry tap (admissions, pieces, ladder rungs,
    evictions, prefix hits, misses, publishes and drops). ``prefix_store``:
    a ``PrefixStore`` to attach (``attach_prefix_store``)."""

    def __init__(
        self,
        model,
        *,
        slots: int = 8,
        chunk: int = 16,
        clock: Callable[[], float] = time.monotonic,
        prefill_buckets: Tuple[int, ...] = (),
        prefill_chunk: int = 0,
        prompt_overflow: str = "error",
        on_event: Optional[Callable[[str, dict], None]] = None,
        prefix_store: Optional[Any] = None,
        device=None,
    ):
        if slots <= 0 or chunk <= 0:
            raise ValueError(f"slots and chunk must be positive, got {slots}, {chunk}")
        if slots > DECODE_ROWS:
            # above it the step's products run at the batch's own row count,
            # and a row's state then depends on its company
            raise ValueError(
                f"slots={slots} exceeds DECODE_ROWS={DECODE_ROWS}, the row count a decode "
                f"step pads its products to: above it a request's tokens are no longer bitwise "
                f"its one-row generate's (ROADMAP.md C1); serve at most {DECODE_ROWS} slots")
        if prompt_overflow not in ("error", "clamp"):
            raise ValueError(f"prompt_overflow must be 'error' or 'clamp', got {prompt_overflow!r}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine on {self.device}")
        self.model = model
        self.slots = int(slots)
        self.chunk = int(chunk)
        self._clock = clock
        self._on_event = on_event
        self.buckets = tuple(prefill_buckets)
        self.prompt_overflow = prompt_overflow
        cfg = model.cfg
        # in-scan prefill: piece boundaries land on linear-attention chunk
        # boundaries (where the pieces replay the monolithic prefill), so
        # the knob is rounded up to that chunk
        self.prefill_chunk = 0
        self.chunk_align = 0
        if prefill_chunk:
            if not self.buckets:
                raise ValueError(
                    "in-scan prefill (prefill_chunk > 0) needs prompt buckets to bound the "
                    "staged buffer's width; set prefill_buckets (e.g. 'pow2') or "
                    "prefill_chunk=0 for host-side prefill")
            c = (resolve_chunk(cfg.chunk) if resolve(cfg.backend, self.device) == "torch"
                 else DEFAULT_CHUNK)
            self.prefill_chunk = -(-int(prefill_chunk) // c) * c
            self.chunk_align = c
        self.prefix_store = None
        if prefix_store is not None:
            self.attach_prefix_store(prefix_store)
        self._pending_prefix: List[Tuple[str, np.ndarray]] = []  # (key, tokens [1, L])
        # the publish queue is bounded: during a store outage novel prefixes
        # keep arriving and nothing drains; past the cap a prefix is dropped
        # (counted, a prefix_drop event): a later cold prefill, never a
        # wrong answer
        self.max_pending_prefixes = 32
        self.dropped_prefixes = 0
        self._sample: Optional[SampleConfig] = None  # set by the first admission
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._chunk_counter = 0  # global boundary index (the serve.chunk hook)
        dev, n = self.device, self.slots
        with torch.inference_mode():
            z = torch.zeros(n, dtype=torch.long, device=dev)
            # free slots are "done"
            self._carry = (z.clone(), init_decode_state(cfg, n, dev), z.clone(), z.clone(),
                           torch.ones(n, dtype=torch.bool, device=dev))
            self._keys = torch.zeros(n, 2, dtype=torch.long, device=dev)
            self._plen, self._pfold = z.clone(), z.clone()
            # the busy slots, kept on the device and written at admission
            # and eviction, so a boundary copies no mask to the card
            self._active_dev = torch.zeros(n, dtype=torch.bool, device=dev)
        # the staging buffer [slots, width]: made at the first in-scan
        # admission, widened to the largest bucket seen
        self._pbuf: Optional[Tensor] = None
        self._done_np = np.ones(n, bool)
        # what each resident slot did at the last boundary (work class and
        # token counts): host values, rebuilt by every step()
        self.last_boundary: List[dict] = []

    def _emit(self, kind: str, **fields) -> None:
        if self._on_event is not None:
            self._on_event(kind, fields)

    def attach_prefix_store(self, store) -> None:
        """Wire a :class:`~orion_tpu_torch.serving.prefix_store.PrefixStore`.
        It needs in-scan prefill (a hit stages the cached state and the
        pieces consume the suffix) and entries aligned on this engine's
        linear-attention chunk."""
        if not self.prefill_chunk:
            raise ValueError("the prefix cache rides in-scan prefill (a hit stages the cached "
                             "state and the pieces consume only the suffix); set prefill_chunk "
                             "> 0 or drop the prefix store")
        if store.align % self.chunk_align != 0:
            raise ValueError(f"prefix store alignment {store.align} is not a multiple of the "
                             f"linear-attention chunk {self.chunk_align}: entries at non-chunk "
                             "positions cannot extend bitwise")
        self.prefix_store = store

    # -- occupancy ------------------------------------------------------------

    @property
    def active_count(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def busy(self) -> bool:
        return self.active_count > 0

    @property
    def has_free_slot(self) -> bool:
        return self.active_count < self.slots

    @property
    def prefilling_count(self) -> int:
        """Slots whose staged prompt is not yet fully consumed."""
        return sum(s is not None and s.prompt_remaining > 0 for s in self._slots)

    def occupancy(self) -> Dict[str, int]:
        """Slot gauges: ``prefilling`` and ``decoding`` split the active
        count by the slots' phase."""
        prefilling = self.prefilling_count
        return {"slots": self.slots, "active": self.active_count,
                "free": self.slots - self.active_count, "prefilling": prefilling,
                "decoding": self.active_count - prefilling}

    def slot_info(self) -> List[Tuple[int, Any, str, int]]:
        """(index, tag, phase, request-local chunk index) of each resident
        slot; phase "prefill" while its staged prompt is unconsumed, else
        "decode". Host bookkeeping, no read-back."""
        return [(i, s.tag, "prefill" if s.prompt_remaining > 0 else "decode", s.chunks)
                for i, s in enumerate(self._slots) if s is not None]

    # -- admission ------------------------------------------------------------

    def _claim_slot(self, sample: SampleConfig) -> int:
        """A free slot, and the request's SampleConfig the resident
        batch's (the programs sample every row with one)."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            raise RuntimeError("no free slot")
        if self._sample is None or not self.busy:
            self._sample = sample
        elif sample != self._sample:
            raise ValueError("request's SampleConfig differs from the resident batch's; the slot "
                             "programs sample every row with one configuration")
        return free[0]

    def _occupy(self, i: int, slot: _Slot) -> None:
        self._slots[i] = slot
        with torch.inference_mode():
            self._active_dev[i] = True

    @torch.inference_mode()
    def admit(self, request: DecodeRequest, tag: Any = None, deadline_at: Optional[float] = None,
              session_id: Optional[str] = None, sample_index: int = 0,
              seed: Optional[int] = None) -> int:
        """Admit ``request`` into a free slot -> its index: prefilled solo
        and inserted, or staged for the in-scan pieces. Raises ValueError
        for a request the engine cannot multiplex (a batch of rows, a
        prompt past the buckets or ``max_seq_len``, another SampleConfig
        than the resident batch's) and RuntimeError when no slot is free;
        the caller fails or reroutes that request.

        ``session_id`` tags the slot for suspension; ``sample_index`` and
        ``seed`` anchor the sampling walk of a rebased session turn: a
        prompt that is a conversation's whole context, after
        ``sample_index`` tokens drawn with the key of ``seed``."""
        prompt = torch.as_tensor(request.prompt).long()
        if prompt.dim() == 1:
            prompt = prompt[None]
        if prompt.shape[0] != 1:
            raise ValueError(f"slot-multiplexed serving takes one sequence per request; got a "
                             f"batch of {prompt.shape[0]} (split it into requests)")
        # bucket check (and clamp) first: the cap check then sees the prompt
        # that would be served
        prompt = self._check_bucket(prompt, request.max_new_tokens)
        cap = self.model.cfg.max_seq_len
        if prompt.shape[1] + request.max_new_tokens > cap:
            raise ValueError(f"prompt {prompt.shape[1]} + new {request.max_new_tokens} exceeds "
                             f"max_seq_len {cap}")
        i = self._claim_slot(request.sample)
        if session_id is None:
            session_id = request.session_id
        seed = request.seed if seed is None else seed
        key = _key_row(seed)
        dprompt = _host_to(prompt, self.device, torch.long)
        remaining = prompt.shape[1] if self.prefill_chunk else 0
        if self.prefill_chunk:
            # with a prefix store, a content hit stages the cached state row
            # at its position, and the pieces consume only the suffix
            entry = self._prefix_lookup(request, prompt.shape[1], tag)
            if entry is not None:
                self._stage_prefix(i, dprompt, key, sample_index, entry)
                remaining = prompt.shape[1] - entry.t
            else:
                self._stage_inscan(i, dprompt, key, sample_index)
                self._queue_prefix_publish(request, prompt.shape[1])
        else:
            self._keys[i, 0], self._keys[i, 1] = key  # the free slot's row: the prefill's key
            sub = prefill_carry(self.model, dprompt, self._sample, self._keys[i:i + 1],
                                sample_index=sample_index, buckets=self.buckets)
            self._insert(i, sub, key, n_emitted=sample_index)
        self._occupy(i, _Slot(
            request=request, tag=tag, deadline_at=deadline_at, prompt=dprompt, toks=[],
            prompt_remaining=remaining, session_id=session_id, seed=int(seed), target_new=request.max_new_tokens,
            fold_base=sample_index))
        self._emit("admit", slot=i, tag=tag, staged=bool(self.prefill_chunk),
                   prompt_len=int(prompt.shape[1]), session=session_id)
        return i

    def _check_bucket(self, prompt: Tensor, max_new: int) -> Tensor:
        """A prompt longer than the largest bucket is refused (default) or
        cut to its newest tokens (``prompt_overflow="clamp"``): to the
        largest bucket that still leaves room for ``max_new`` under
        ``max_seq_len``, refused if none does."""
        if not self.buckets or bucket_for(prompt.shape[1], self.buckets) is not None:
            return prompt
        if self.prompt_overflow == "clamp":
            cap = self.model.cfg.max_seq_len
            fit = [b for b in self.buckets if b + max_new <= cap]
            if fit:
                return prompt[:, -max(fit):]
            raise ValueError(
                f"prompt length {prompt.shape[1]} exceeds the largest prefill bucket "
                f"{self.buckets[-1]} and no bucket leaves room for {max_new} new tokens under "
                f"max_seq_len {cap}")
        raise ValueError(
            f"prompt length {prompt.shape[1]} exceeds the largest prefill bucket "
            f"{self.buckets[-1]}; refuse (default) or serve the newest bucket-sized context "
            "with prompt_overflow='clamp'")

    def _staged_row(self, prompt: Tensor) -> Tensor:
        """The staging buffer widened to the prompt's bucket if needed (its
        widths are bucket values), and the prompt as a row of its width."""
        b = bucket_for(prompt.shape[1], self.buckets)
        width = 0 if self._pbuf is None else self._pbuf.shape[1]
        if b > width:
            if self._pbuf is None:
                self._pbuf = torch.zeros(self.slots, b, dtype=torch.long, device=self.device)
            else:
                self._pbuf = F.pad(self._pbuf, (0, b - width))
            width = b
        return F.pad(prompt, (0, width - prompt.shape[1]))[0]

    def _stage_inscan(self, i: int, prompt: Tensor, key: List[int], sample_index: int) -> None:
        row = self._staged_row(prompt)
        _stage_prompt_carry(self._carry, self._keys, self._plen, self._pfold, self._pbuf, row,
                            key, i, prompt.shape[1], sample_index)

    # -- the content-addressed prefix cache (serving/prefix_store.py) ------------------
    # This side of the store is hashing, disk and row writes: the store owns
    # the one read of the card (the publish's copy of the state to the host).

    def _prefix_lookup(self, request: DecodeRequest, prompt_len: int, tag):
        """The longest cached aligned prefix of the request's prompt, or None.
        It keys off the REQUEST's host tokens; a clamped prompt (overflow
        mode: the served tokens are not the submitted ones) skips the lookup
        and counts as a miss."""
        if self.prefix_store is None:
            return None
        raw = _host_tokens(request.prompt)
        if raw.shape[1] != prompt_len:
            self._emit("prefix_miss", tag=tag, prompt_len=int(prompt_len), clamped=True)
            return None
        entry = self.prefix_store.lookup(raw, declared=max(request.prefix_len, 0))
        if entry is not None and entry.t % max(self.chunk_align, 1) != 0:
            entry = None  # another alignment: unusable for the in-scan pieces
        if entry is None:
            self._emit("prefix_miss", tag=tag, prompt_len=int(prompt_len))
            return None
        self._emit("prefix_hit", tag=tag, prefix_len=int(entry.t),
                   suffix=int(prompt_len) - int(entry.t), key=entry.key,
                   generation=int(entry.generation))
        return entry

    def _stage_prefix(self, i: int, prompt: Tensor, key: List[int], sample_index: int,
                      entry) -> None:
        """O(suffix) admission on a hit: the WHOLE prompt is staged (the
        ladder's restart rung replays from scratch) but the row starts at
        ``t = entry.t`` with the cached state, copied to the card pinned and
        asynchronously."""
        row = self._staged_row(prompt)
        st1 = [{k: _host_to(v, self.device) for k, v in st.items()} for st in entry.state]
        _stage_prefix_carry(self._carry, self._keys, self._plen, self._pfold, self._pbuf, st1,
                            row, key, i, prompt.shape[1], sample_index, int(entry.t))

    def _queue_prefix_publish(self, request: DecodeRequest, prompt_len: int) -> None:
        """A miss on a request DECLARING a shared prefix queues the aligned
        prefix for publication (deduplicated by key; skipped when an entry
        is committed already). The prefill and the write run in
        :meth:`publish_pending_prefixes`, off the admission path."""
        if self.prefix_store is None or request.prefix_len <= 0:
            return
        pub = self.prefix_store.publish_length(prompt_len, request.prefix_len)
        if pub <= 0:
            return
        row = _host_tokens(request.prompt)[:, :pub]
        key = self.prefix_store.key_for(row)
        if any(k == key for k, _ in self._pending_prefix):
            return
        br = self.prefix_store.breaker
        # during an outage no disk probe on the admission path: queue blind;
        # the publish pass checks for the entry again after recovery
        if br is None or not br.is_open:
            try:
                if self.prefix_store.generations(key):
                    return  # committed already (here or by another replica)
            except StoreUnavailableError:
                pass  # the breaker tripped mid-check: queue blind
        if len(self._pending_prefix) >= self.max_pending_prefixes:
            self.dropped_prefixes += 1
            self._emit("prefix_drop", key=key, dropped_total=self.dropped_prefixes)
            return
        self._pending_prefix.append((key, row))

    @property
    def has_pending_prefixes(self) -> bool:
        """Queued publishes awaiting :meth:`publish_pending_prefixes` (the
        Server beats its watchdog before it publishes)."""
        return bool(self._pending_prefix)

    @property
    def pending_prefix_count(self) -> int:
        """The bounded publish queue's depth."""
        return len(self._pending_prefix)

    @torch.inference_mode()
    def publish_pending_prefixes(self) -> int:
        """Publish the queued prefixes -> how many entries were written: each
        prefilled solo (``prefill_carry``, rows 1 and 6 on the card) and its
        state handed to the store, which copies it to the host. The prefill
        runs at the prefix's exact length, not its bucket: a bucket's padding
        would run the products at another row count, which on the card
        rounds apart from the pieces a cold request runs. A failed publish
        degrades to "not cached" with a warning; with the breaker open the
        entry waits in the queue for recovery.

        This runs between boundaries, so the first declared novel prefix
        stalls the resident slots for one solo prefill, once per prefix and
        store; it cannot ride the cold request's own pieces (they advance
        ``t`` by ``prefill_chunk``, so the scan's state never sits at the
        declared length, and the publish must not change the pieces)."""
        done = 0
        br = self.prefix_store.breaker
        if br is not None and br.blocked():
            return 0  # an outage, the probe not due: the queue waits
        while self._pending_prefix:
            key, row = self._pending_prefix.pop(0)
            try:
                if self.prefix_store.generations(key):
                    continue  # another replica committed it since
                keys = request_keys(0, 1, self.device)
                carry = prefill_carry(self.model, _host_to(row, self.device, torch.long),
                                      self._sample, keys)
                gen = self.prefix_store.publish(row, carry[1])
                if gen is None:
                    continue  # raced: a peer committed it mid-prefill
                done += 1
                self._emit("prefix_publish", key=key, length=int(row.shape[1]), generation=gen)
            except StoreUnavailableError:
                # the breaker is open (or the probe this pass rode failed):
                # requeue and stop; it publishes after recovery
                self._pending_prefix.insert(0, (key, row))
                break
            except Exception as e:
                if br is not None and br.is_open:
                    # this failure tripped the breaker: keep the entry, its
                    # retry is the probe that closes the breaker
                    self._pending_prefix.insert(0, (key, row))
                    warnings.warn(f"prefix publish failed ({type(e).__name__}); store breaker "
                                  "open -- entry queued for recovery", stacklevel=2)
                    break
                warnings.warn(f"prefix publish failed ({type(e).__name__}: {e}); serving "
                              "continues uncached", stacklevel=2)
        return done

    @torch.inference_mode()
    def resume(self, sess: SessionState, request: DecodeRequest, tag: Any = None,
               deadline_at: Optional[float] = None) -> int:
        """Re-admit a suspended session into a free slot: its carry row
        written back at its position and key fold, no prefill; bitwise as if
        the slot had stayed resident. The tokens its last chunk emitted past
        the served ones ride as the slot's ``prefix``, served before any
        token decoded now."""
        if request.sample != sess.sample:
            raise ValueError("continuation SampleConfig differs from the session's: the resumed "
                             "sampling walk is only bitwise under the one it was suspended with")
        prefix = np.asarray(sess.emitted[:, sess.served:])
        target_new = request.max_new_tokens - prefix.shape[1]
        if target_new <= 0:
            raise ValueError("continuation fully covered by the session's buffered tokens; the "
                             "caller should serve it without a slot")
        cap = self.model.cfg.max_seq_len
        if int(sess.t) + target_new > cap:
            raise ValueError(f"session at position {int(sess.t)} + new {target_new} exceeds "
                             f"max_seq_len {cap}")
        i = self._claim_slot(request.sample)
        key = _key_row(sess.seed)
        dev = self.device
        sub = (_host_to(sess.token, dev, torch.long),
               [{k: _host_to(v, dev) for k, v in st.items()} for st in sess.state],
               int(sess.t), _host_to(sess.done, dev, torch.bool))
        self._insert(i, sub, key, n_emitted=int(sess.emit))
        self._occupy(i, _Slot(
            request=request, tag=tag, deadline_at=deadline_at,
            prompt=_host_to(sess.prompt, dev, torch.long), toks=[], session_id=sess.session_id,
            seed=int(sess.seed), prior=[np.asarray(sess.emitted)] if sess.emitted.size else [],
            prefix=prefix if prefix.size else None, target_new=target_new,
            fold_base=int(sess.emit), served_base=int(sess.served)))
        self._emit("resume", slot=i, tag=tag, session=sess.session_id, t=int(sess.t),
                   generation=int(sess.generation))
        return i

    def _insert(self, i: int, sub_carry, key: List[int], n_emitted: int = 0) -> None:
        _insert_carry(self._carry, self._keys, self._plen, self._pfold, sub_carry, key, i,
                      n_emitted)

    # -- the boundary ---------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> List[Tuple[Any, DecodeResult]]:
        """Advance every resident slot by one chunk (the caller steps only
        while ``busy``) -> (tag, DecodeResult) of every request that
        finished at this boundary: ok, deadline, or failed when its ladder
        is exhausted. Decode-state faults raise nothing."""
        inject.fire("serve.chunk", step=self._chunk_counter)
        finished: List[Tuple[Any, DecodeResult]] = []
        self.last_boundary = []
        # deadlines first, before paying for the chunk
        now = self._clock()
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.deadline_at is not None and now >= slot.deadline_at:
                finished.append((slot.tag, self._finish(i, "deadline")))
        if not self.busy:
            self._chunk_counter += 1
            return finished
        active = np.array([s is not None for s in self._slots])
        unified = self.prefilling_count > 0
        snap = _copy_carry(self._carry)
        carry, toks = self._attempt(self._carry, self._active_dev, unified)
        bad = self._probe_bad(carry, active)
        if bad:
            carry, toks, bad = self._ladder(snap, active, carry, toks, bad, unified)
            for i in sorted(bad):  # the ladder is exhausted: fail those requests
                slot = self._slots[i]
                self.last_boundary.append({
                    "slot": i, "tag": slot.tag, "failed": True,
                    "frozen": slot.prompt_remaining > 0,
                    "decode_steps": 0 if slot.prompt_remaining > 0 else self.chunk,
                    "prefill_tokens": 0, "decode_tokens": 0})
                finished.append((slot.tag, self._finish(i, "failed")))
                active[i] = False
        self._carry = carry
        piece = self._piece_tokens()
        # the host mirror of the piece's slot (the accepted attempt's
        # selection over the same inputs): no read-back
        sel = self._selected_prefill_slot(active)
        for i, slot in enumerate(self._slots):
            if slot is None or not active[i]:
                continue
            slot.chunks += 1
            if slot.prompt_remaining > 0:
                if i != sel:  # frozen: another slot had the budget
                    self.last_boundary.append({"slot": i, "tag": slot.tag, "frozen": True,
                                               "decode_steps": 0, "prefill_tokens": 0,
                                               "decode_tokens": 0})
                    continue
                consumed = min(piece, slot.prompt_remaining)
                slot.prompt_remaining -= consumed
                self._emit("prefill_piece", slot=i, tag=slot.tag, consumed=consumed,
                           remaining=slot.prompt_remaining)
                if slot.prompt_remaining > 0:  # still mid-prefill: nothing emitted
                    self.last_boundary.append({"slot": i, "tag": slot.tag, "decode_steps": 0,
                                               "prefill_tokens": consumed, "decode_tokens": 0})
                    continue
            else:
                consumed = 0
            slot.toks.append((toks, i, self.chunk))
            slot.n_emitted += self.chunk
            self.last_boundary.append({"slot": i, "tag": slot.tag, "decode_steps": self.chunk,
                                       "prefill_tokens": consumed,
                                       "decode_tokens": self.chunk})
            if slot.n_emitted >= slot.target_new or self._done_np[i]:
                finished.append((slot.tag, self._finish(i, "ok")))
        self._chunk_counter += 1
        return finished

    def _piece_tokens(self) -> int:
        """The boundary's prompt-token budget, capped at the staging
        buffer's width (the unified program's own cap)."""
        if not self.prefill_chunk or self._pbuf is None:
            return self.prefill_chunk
        return min(self.prefill_chunk, self._pbuf.shape[1])

    def _selected_prefill_slot(self, active) -> Optional[int]:
        """The host mirror of the unified program's choice: least prompt
        left first, ties to the lowest index, over the slots of the
        accepted attempt's mask (rung 3 can mask a prefilling slot out and
        move the budget to its neighbour)."""
        best = None
        for i, slot in enumerate(self._slots):
            if slot is None or not active[i] or slot.prompt_remaining <= 0:
                continue
            if best is None or slot.prompt_remaining < self._slots[best].prompt_remaining:
                best = i
        return best

    def _attempt(self, carry, active_dev: Tensor, unified: bool = False):
        """One batched boundary attempt from ``carry`` (its caches advanced
        in place): the unified prefill + decode program while a slot is
        mid-prefill, the pure decode program otherwise -> (carry, tokens [S,
        chunk]). An armed per-slot (or per-chunk) decode-state fault poisons
        its slot afterwards, so each ladder rung is reachable on purpose."""
        if unified:
            out, toks = decode_batched_prefill_chunk(
                self.model, carry, self._keys, active_dev, self._pbuf, self._plen, self._pfold,
                self.chunk, self.prefill_chunk, self._sample)
        else:
            out, toks = decode_batched_chunk(self.model, carry, self._keys, active_dev,
                                             self.chunk, self._sample)
        if inject.active():
            for i, slot in enumerate(self._slots):
                if slot is not None and (inject.decode_slot_nan_armed(i, slot.chunks)
                                         or inject.decode_nan_armed(slot.chunks)):
                    self._poison_slot(out, i)
        return out, toks

    @staticmethod
    def _poison_slot(carry, i: int) -> None:
        for st in carry[1]:
            for x in st.values():
                if x.is_floating_point():
                    x[i] = float("nan")

    def _probe_bad(self, carry, active: np.ndarray) -> set:
        """The boundary's one read of the card: the per-slot finite mask
        and the done flags in one [2, slots] transfer (free slots ignored:
        a failed request's NaN stays in its row until the next admission
        overwrites it). The done row is kept for the eviction pass."""
        flags = torch.stack([decode_state_finite_per_slot(carry[1]), carry[4]]).cpu().numpy()
        self._done_np = flags[1]
        return {i for i in range(self.slots) if active[i] and not flags[0][i]}

    def _ladder(self, snap, active, carry, toks, bad, unified=False):
        """Walk the per-slot ladder: redo the whole boundary from a fresh
        copy of the snapshot (the rewind: the untouched slots recompute
        their tokens bitwise, a slot mid-prefill replays its piece, the
        poisoned slot gets its retry); then rebuild the still-bad slots
        into the snapshot (re-prefill, or a restarted prefill) and redo;
        then mask the exhausted slots out and redo once more, so the others
        still get their chunk. -> (carry, tokens, exhausted slots)."""
        carry, toks = self._attempt(_copy_carry(snap), self._active_dev, unified)
        bad2 = self._probe_bad(carry, active)
        for i in bad:
            self._slots[i].rewinds += 1
            self._emit("ladder", rung="rewind", slot=i, chunk=self._slots[i].chunks,
                       tag=self._slots[i].tag)
        if not bad2:
            return carry, toks, set()
        # rung 2: the snapshot itself is poisoned for those slots: rebuild
        # each from the tokens, the one thing known good
        for i in sorted(bad2):
            rung = "prefill_restart" if self._slots[i].prompt_remaining > 0 else "reprefill"
            self._reprefill_into(snap, i)
            self._slots[i].reprefills += 1
            self._emit("ladder", rung=rung, slot=i, chunk=self._slots[i].chunks,
                       tag=self._slots[i].tag)
        carry, toks = self._attempt(_copy_carry(snap), self._active_dev, unified)
        bad3 = self._probe_bad(carry, active)
        if not bad3:
            return carry, toks, set()
        # rung 3: the exhausted slots masked out; the survivors' tokens and
        # done flags replay bitwise, so the probe read above stays valid
        still = self._active_dev.clone()
        for i in bad3:
            still[i] = False
            self._emit("ladder", rung="exhausted", slot=i, chunk=self._slots[i].chunks,
                       tag=self._slots[i].tag)
        if any(active[i] and i not in bad3 for i in range(self.slots)):
            carry, toks = self._attempt(_copy_carry(snap), still, unified)
        return carry, toks, bad3

    def _reprefill_into(self, snap, i: int) -> None:
        """Ladder rung 2 for slot ``i``, into the snapshot in place: a solo
        re-prefill of prompt + the tokens emitted so far
        (``reprefill_carry``; the first token drawn at the fold the carry
        held: ``fold_base + n_emitted``), or for a slot still mid-prefill
        (nothing emitted) a restart of its in-scan prefill from a zero row.
        A resumed session's history spans turns: ``prior`` comes before
        this turn's chunks."""
        slot = self._slots[i]
        if slot.prompt_remaining > 0:
            slot.prompt_remaining = slot.prompt.shape[1]
            _restart_prefill_row(snap, i)
            return
        emitted = [_host_to(a, self.device, torch.long) for a in slot.prior] + [
            arr[row:row + 1, :n] for arr, row, n in slot.toks]
        fold = slot.fold_base + slot.n_emitted
        sub = reprefill_carry(self.model, slot.prompt, emitted, self._sample,
                              self._keys[i:i + 1], buckets=self.buckets, sample_index=fold)
        _insert_carry(snap, self._keys, self._plen, self._pfold, sub, _key_row(slot.seed), i,
                      fold)

    # -- eviction -------------------------------------------------------------

    def _evict(self, i: int, status: str) -> DecodeResult:
        """Free slot ``i`` and make its request's result: the one read of
        its tokens a request. A resumed session's buffered ``prefix`` comes
        first; the total is cut to ``max_new_tokens`` (the engine runs
        whole chunks), and an early EOS pads the tail as the solo walk
        emits it."""
        slot = self._slots[i]
        self._slots[i] = None
        with torch.inference_mode():
            self._active_dev[i] = False
        req = slot.request
        want = req.max_new_tokens
        parts = [] if slot.prefix is None else [slot.prefix]
        if slot.toks:
            parts.append(torch.cat([arr[row:row + 1, :n] for arr, row, n in slot.toks],
                                   dim=1).cpu().numpy())
        tokens = (np.concatenate(parts, axis=1)[:, :want] if parts
                  else np.zeros((1, 0), np.int64))
        n = tokens.shape[1]
        if status == "ok" and n < want:
            pad = np.full((1, want - n), req.sample.pad_token, tokens.dtype)
            tokens = np.concatenate([tokens, pad], axis=1)
            n = want
        return DecodeResult(tokens=tokens, status=status, new_tokens=n, chunks=slot.chunks,
                            rewinds=slot.rewinds, reprefills=slot.reprefills)

    def _finish(self, i: int, status: str) -> DecodeResult:
        """Evict slot ``i``, through suspension (its state as a
        ``SessionState`` on the result) when it carries a session id and
        its state can be trusted: never for ``failed`` (the store's last
        generation stays the session's truth) and never mid-prefill (a
        partial prompt is not a turn boundary: it evicts with zero
        tokens)."""
        slot = self._slots[i]
        suspend = (slot.session_id is not None and status != "failed"
                   and slot.prompt_remaining == 0)
        self._emit("evict", slot=i, tag=slot.tag, status=status, session=slot.session_id,
                   chunks=slot.chunks, suspended=suspend)
        return self._suspend(i, status) if suspend else self._evict(i, status)

    def _suspend(self, i: int, status: str) -> DecodeResult:
        """Suspend slot ``i``: its carry row copied to the host, and the
        slot freed. The ``SessionState`` rides out on the result, for the
        caller to persist before it releases the tokens."""
        slot = self._slots[i]
        token, state, t, emit, done = _extract_carry(self._carry, i)
        rows = ([torch.cat([arr[row:row + 1, :n] for arr, row, n in slot.toks],
                           dim=1).cpu().numpy()] if slot.toks else [])
        emitted = np.concatenate([np.asarray(a) for a in slot.prior] + rows, axis=1) if (
            slot.prior or rows) else np.zeros((1, 0), np.int64)
        prompt = slot.prompt.cpu().numpy()
        served_base = slot.served_base
        result = self._evict(i, status)
        result.session = SessionState(
            session_id=slot.session_id, seed=slot.seed, sample=self._sample,
            served=min(served_base + result.new_tokens, emitted.shape[1]),
            token=token.cpu().numpy(), state=[{k: v.cpu() for k, v in st.items()}
                                              for st in state],
            t=t.cpu().numpy(), emit=emit.cpu().numpy(), done=done.cpu().numpy(),
            prompt=prompt, emitted=emitted)
        return result

    @torch.inference_mode()
    def suspend_sessions(self) -> List[Tuple[Any, DecodeResult]]:
        """Suspend every resident session-tagged slot mid-stream with status
        ``"suspended"`` (its tokens so far, the session attached): the
        drain path, where a conversation survives a restart as one O(1)
        snapshot. Slots without a session are left to finish."""
        return [(slot.tag, self._finish(i, "suspended")) for i, slot in enumerate(self._slots)
                if slot is not None and slot.session_id is not None]

    @torch.inference_mode()
    def drain_evict_all(self, status: str = "failed") -> List[Tuple[Any, DecodeResult]]:
        """Evict every resident request with its tokens so far: the last
        resort when the serving loop must exit now."""
        out = []
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._emit("evict", slot=i, tag=slot.tag, status=status,
                           session=slot.session_id, chunks=slot.chunks, suspended=False,
                           forced=True)
                out.append((slot.tag, self._evict(i, status)))
        return out


__all__ = ["SlotEngine", "parse_buckets"]
