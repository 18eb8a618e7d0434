"""Durable session store: crash-safe suspend / resume of O(1) decode state.
The port's counterpart of ``orion_tpu/serving/session_store.py``.

A conversation's whole decode state is one small (S, z)-plus-caches row, so
the store suspends a session as ONE checksummed blob and re-admits it later
bitwise as if the slot had stayed resident. Multi-turn chat, idle-slot
eviction and a SIGTERM drain that survives a restart are the same operation:
extract the slot row (``SlotEngine`` hands out a :class:`SessionState`),
publish it atomically, and later row-write it back
(``SlotEngine.resume``) at its position and key fold.

Durability (as ``training/checkpoint.py``):

- **generations** -- each save writes a new ``gen-%06d.bin`` (the leaves'
  bytes, concatenated) then ``gen-%06d.json`` (the metadata and the per-leaf
  shape / dtype / crc32 manifest of ``checkpoint.build_manifest``), each to a
  temporary name then ``os.replace``: the manifest rename is the COMMIT
  POINT, so a kill anywhere mid-save leaves the previous generation intact
  and the half-written one invisible. A bfloat16 leaf (a bf16 model's K/V
  cache or ring) is written as its 16-bit words and recorded as
  ``"bfloat16"``, so it round-trips bitwise (numpy has no bfloat16).
- **verified restore** -- ``load`` re-checksums every leaf against the
  manifest and falls back to the next-newest intact generation with a loud
  warning when the latest is corrupt or truncated; only when every
  generation is damaged does it raise :class:`SessionIntegrityError`, which
  the Server maps to failing THAT session's request.
- **weights identity** -- every generation is stamped with the serving
  weights' identity (params id + qmode); a load under another identity
  raises :class:`SessionIdentityError` (same shapes, wrong numbers: never a
  fallback).
- **retries** -- all I/O runs under ``resilience/retry.py`` with the
  ``serve.session_save`` / ``serve.session_load`` fault hooks inside the
  retried region (and ``serve.session_scan`` before each listing);
  ``should_abort`` stops a draining Server from spending its grace period on
  backoff.
- **breaker** -- with a ``resilience.breaker.CircuitBreaker`` each public
  operation is one breaker sample, and while it is open every operation
  raises ``StoreUnavailableError`` before any disk syscall.

The store knows nothing of models or engines: a payload is a tree of host
arrays (numpy) and CPU tensors plus a few scalars.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from orion_tpu_torch.generate import SampleConfig
from orion_tpu_torch.resilience.breaker import CircuitBreaker, StoreUnavailableError
from orion_tpu_torch.resilience.inject import fire
from orion_tpu_torch.resilience.retry import RetryPolicy, call_with_retries
from orion_tpu_torch.training.checkpoint import (atomic_write_json, build_manifest,
                                                 tensor_bytes, verify_manifest)

SESSION_FORMAT_VERSION = 1
_SID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._\-]{0,127}$")


class SessionIntegrityError(RuntimeError):
    """Every on-disk generation of a session failed manifest verification
    (or was unreadable). Fails that session's request only: the Server keeps
    serving everyone else."""


class SessionIdentityError(SessionIntegrityError):
    """The session was suspended under another weights identity (params id +
    qmode) than this server runs. Not a fallback case: older generations
    share the identity, and resuming cross-checkpoint or cross-qmode state
    would silently diverge, so the mismatch is that request's error."""


@dataclasses.dataclass
class SessionState:
    """One suspended conversation: the slot's carry row, copied to the host,
    and what a resume needs beside it.

    - ``token`` / ``state`` / ``t`` / ``emit`` / ``done`` -- the batch-1
      carry row as extracted at a chunk boundary (``state``: the per-layer
      decode state, dicts of CPU tensors); ``emit`` is the index of the
      last token the row drew, its key's fold, so a resume at ``emit``
      draws the uninterrupted walk's tokens;
    - ``prompt`` -- the context the state was built from (the first prompt,
      or the rebased whole history after a turn that brought new tokens);
      the ladder's re-prefill rung rebuilds from ``prompt`` + ``emitted``;
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

    def arrays(self) -> Dict[str, Any]:
        """The manifested tree (dict keys sorted are the serialization
        order: :func:`_encode_tree` walks them as the manifest does)."""
        return {"token": self.token, "state": self.state, "t": self.t, "emit": self.emit,
                "done": self.done, "prompt": self.prompt, "emitted": self.emitted}

    @property
    def buffered(self) -> int:
        """Emitted-but-unserved tokens a continuation serves first."""
        return max(int(self.emitted.shape[1]) - int(self.served), 0)


# -- tree <-> flat blob ---------------------------------------------------------------


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return torch.from_numpy(np.array(leaf, copy=True))


def _encode_tree(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """A JSON-able structure with the leaves replaced by indices into
    ``leaves`` (as CPU tensors). Dict keys are walked sorted and lists /
    tuples in order: the order ``checkpoint.build_manifest`` walks, so leaf i
    lines up with manifest leaf i."""
    if isinstance(tree, dict):
        return {"d": {k: _encode_tree(tree[k], leaves) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"l": [_encode_tree(v, leaves) for v in tree], "t": isinstance(tree, tuple)}
    leaves.append(_as_tensor(tree))
    return {"a": len(leaves) - 1}


def _decode_tree(node: Any, leaves: List[torch.Tensor]) -> Any:
    if "a" in node:
        return leaves[node["a"]]
    if "d" in node:
        return {k: _decode_tree(v, leaves) for k, v in node["d"].items()}
    seq = [_decode_tree(v, leaves) for v in node["l"]]
    return tuple(seq) if node.get("t") else seq


def _torch_dtype(name: str) -> torch.dtype:
    """A dtype from its manifest string (``"bfloat16"``, ``"int64"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a manifest")
    return dt


def _blob(manifest: Dict[str, Any], leaves: List[torch.Tensor]) -> bytes:
    """The leaves' bytes, concatenated, each manifest leaf stamped with its
    offset and size."""
    if len(manifest["leaves"]) != len(leaves):
        raise AssertionError("serialization order diverged from the manifest's walk "
                             f"({len(leaves)} vs {manifest['n_leaves']} leaves)")
    parts, offset = [], 0
    for entry, t in zip(manifest["leaves"], leaves):
        raw = tensor_bytes(t)
        entry["offset"], entry["nbytes"] = offset, len(raw)
        offset += len(raw)
        parts.append(raw)
    return b"".join(parts)


def _leaves_from(manifest: Dict[str, Any], blob: bytes, what: str,
                 error=ValueError) -> List[torch.Tensor]:
    """The manifest's leaves cut out of ``blob`` as CPU tensors (copies);
    ``error`` for a payload cut short."""
    out = []
    for entry in manifest["leaves"]:
        raw = blob[entry["offset"]:entry["offset"] + entry["nbytes"]]
        if len(raw) != entry["nbytes"]:
            raise error(f"{what}: payload truncated at leaf {entry['path']}")
        dt = _torch_dtype(entry["dtype"])
        if not raw:
            out.append(torch.empty(entry["shape"], dtype=dt))
            continue
        flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        out.append(flat.view(dt).reshape(entry["shape"]))
    return out


# -- the store ------------------------------------------------------------------------


class _BreakerIO:
    """The stores' breaker gate and raw I/O: the ``_io_*`` helpers are a
    store's only filesystem touch points, and each fails fast with
    ``StoreUnavailableError`` while the breaker is open and its probe not
    due, so during an outage a store touch costs one lock and one clock read,
    never a syscall against dead storage."""

    _STORE = ""
    _SCAN_SITE = ""

    def __init__(self, breaker: Optional[CircuitBreaker]):
        self.breaker = breaker

    def _exit(self, ok: bool, reason: str = "") -> None:
        if self.breaker is None:
            return
        if ok:
            self.breaker.record_success()
        else:
            self.breaker.record_failure(reason)

    def _blocked_check(self) -> None:
        if self.breaker is not None and self.breaker.blocked():
            raise StoreUnavailableError(self._STORE)

    def _io_open(self, path: str, mode: str = "r", **kw):
        self._blocked_check()
        return open(path, mode, **kw)

    def _io_listdir(self, path: str) -> List[str]:
        """A directory's names, or [] for a path that does not exist (a
        session never saved, a prefix never published): missing is an
        answer, not a store fault."""
        self._blocked_check()
        fire(self._SCAN_SITE)
        try:
            return os.listdir(path)
        except (FileNotFoundError, NotADirectoryError):
            return []

    def _io_replace(self, src: str, dst: str) -> None:
        self._blocked_check()
        os.replace(src, dst)

    def _io_makedirs(self, path: str) -> None:
        self._blocked_check()
        os.makedirs(path, exist_ok=True)

    def _io_remove(self, path: str) -> None:
        self._blocked_check()
        os.remove(path)

    def _io_rmdir(self, path: str) -> None:
        self._blocked_check()
        os.rmdir(path)

    @staticmethod
    def _bin(d: str, gen: int) -> str:
        return os.path.join(d, f"gen-{gen:06d}.bin")

    @staticmethod
    def _json(d: str, gen: int) -> str:
        return os.path.join(d, f"gen-{gen:06d}.json")

    def _committed(self, d: str) -> List[int]:
        """COMMITTED generations under ``d`` (manifest present), oldest
        first: a ``.bin`` without its ``.json`` is a torn save, invisible."""
        out = []
        for name in self._io_listdir(d):
            if name.startswith("gen-") and name.endswith(".json"):
                try:
                    out.append(int(name[len("gen-"):-len(".json")]))
                except ValueError:
                    continue
        return sorted(out)

    def _delete_dir(self, d: str) -> None:
        """Best effort: every file of ``d``, then ``d``."""
        try:
            names = self._io_listdir(d)
        except (OSError, StoreUnavailableError):
            return
        for name in names:
            try:
                self._io_remove(os.path.join(d, name))
            except (OSError, StoreUnavailableError):
                pass
        try:
            self._io_rmdir(d)
        except (OSError, StoreUnavailableError):
            pass


class SessionStore(_BreakerIO):
    """Generation-per-save durable store under ``directory/<session_id>/``.

    ``keep``: generations kept per session (the newest is live, the rest are
    fallbacks for a damaged latest). ``should_abort``: polled by the retry
    layer. ``observer``: ``("save" | "load", ms)`` after each completed
    operation (host-only telemetry). ``identity``: the serving weights'
    identity stamped on every generation and checked at load (None skips
    the check). ``breaker``: the store's circuit breaker; each public
    operation (save, load, a generations scan) is one breaker sample,
    retries included."""

    _STORE = "session"
    _SCAN_SITE = "serve.session_scan"

    def __init__(self, directory: str, keep: int = 2, retry: Optional[RetryPolicy] = None,
                 should_abort: Optional[Callable[[], bool]] = None,
                 observer: Optional[Callable[[str, float], None]] = None,
                 clock: Callable[[], float] = time.monotonic, identity: Optional[str] = None,
                 breaker: Optional[CircuitBreaker] = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        super().__init__(breaker)
        self.directory = os.path.abspath(directory)
        self.identity = identity
        self.keep = int(keep)
        self._retry = retry if retry is not None else RetryPolicy()
        self._should_abort = should_abort
        self._observer = observer
        self._clock = clock
        os.makedirs(self.directory, exist_ok=True)

    def _observe(self, op: str, t0: float) -> None:
        if self._observer is not None:
            try:
                self._observer(op, (self._clock() - t0) * 1e3)
            except Exception:
                pass  # telemetry must never fail the I/O it measures

    def _enter(self) -> None:
        if self.breaker is not None and not self.breaker.allow():
            raise StoreUnavailableError(self._STORE)

    def _dir(self, session_id: str) -> str:
        if not _SID_RE.match(session_id):
            raise ValueError(f"invalid session id {session_id!r}: ids are path components "
                             "([A-Za-z0-9._-], must not start with a dot, max 128 chars)")
        return os.path.join(self.directory, session_id)

    def generations(self, session_id: str) -> List[int]:
        """Committed generations of one session, oldest first: one breaker
        sample (the staleness probe of a session lookup)."""
        self._enter()
        try:
            out = self._committed(self._dir(session_id))
        except StoreUnavailableError:
            raise
        except OSError as e:
            self._exit(False, f"scan: {type(e).__name__}")
            raise
        self._exit(True)
        return out

    def newest_generation(self, session_id: str) -> int:
        """The newest committed generation (0 = never saved): the check a
        resident copy must pass before it is trusted."""
        gens = self.generations(session_id)
        return gens[-1] if gens else 0

    def list_sessions(self) -> List[str]:
        return sorted(n for n in self._io_listdir(self.directory)
                      if self._committed(os.path.join(self.directory, n)))

    # -- save -------------------------------------------------------------------------

    def save(self, state: SessionState) -> int:
        """Persist one new generation -> its number. Payload then manifest,
        each renamed into place: the manifest is the commit point. One
        breaker sample; ``StoreUnavailableError`` with no syscall while the
        breaker is open (the Server maps it to a DIRTY pin)."""
        self._enter()
        try:
            return self._save_op(state)
        except StoreUnavailableError:
            raise
        except OSError as e:
            self._exit(False, f"save: {type(e).__name__}")
            raise
        # other exceptions are corruption- or bug-shaped, not outage
        # evidence: they propagate without a breaker sample

    def _save_op(self, state: SessionState) -> int:
        d = self._dir(state.session_id)
        gens = self._committed(d)
        gen = (gens[-1] if gens else 0) + 1
        leaves: List[torch.Tensor] = []
        structure = _encode_tree(state.arrays(), leaves)
        manifest = build_manifest(state.arrays(), gen)
        blob = _blob(manifest, leaves)
        doc = {"format": SESSION_FORMAT_VERSION, "session_id": state.session_id,
               "identity": self.identity, "generation": gen, "seed": int(state.seed),
               "served": int(state.served), "sample": dataclasses.asdict(state.sample),
               "structure": structure, "manifest": manifest}

        def _write():
            fire("serve.session_save", step=gen)
            self._io_makedirs(d)
            tmp = self._bin(d, gen) + ".tmp"
            with self._io_open(tmp, "wb") as f:
                f.write(blob)
            self._io_replace(tmp, self._bin(d, gen))
            self._blocked_check()
            atomic_write_json(self._json(d, gen), doc)  # the commit point

        t0 = self._clock()
        call_with_retries(_write, self._retry,
                          describe=f"session save ({state.session_id} gen {gen})",
                          should_abort=self._should_abort)
        self._exit(True)
        self._observe("save", t0)
        state.generation = gen
        self._gc(d, keep_from=gen)
        return gen

    def _gc(self, d: str, keep_from: int) -> None:
        """Drop generations older than the newest ``keep`` and any stranded
        tmp file. Advisory: a failure is retried by the next save."""
        floor = keep_from - self.keep + 1
        try:
            names = self._io_listdir(d)
        except (OSError, StoreUnavailableError):
            return
        for name in names:
            path = os.path.join(d, name)
            try:
                if name.endswith(".tmp"):
                    self._io_remove(path)
                    continue
                if not name.startswith("gen-"):
                    continue
                if int(name.split(".", 1)[0][len("gen-"):]) < floor:
                    self._io_remove(path)
            except (OSError, ValueError, StoreUnavailableError):
                continue

    # -- load -------------------------------------------------------------------------

    def load(self, session_id: str) -> Optional[SessionState]:
        """The newest intact generation of ``session_id``, or None when it
        was never saved. A corrupt or truncated latest falls back to the
        previous committed generation with a warning; when none verifies,
        :class:`SessionIntegrityError` (or the OSError, when the store
        itself failed: an outage, not corruption). One breaker sample."""
        self._enter()
        try:
            out = self._load_op(session_id)
        except StoreUnavailableError:
            raise
        except OSError as e:
            self._exit(False, f"load: {type(e).__name__}")
            raise
        self._exit(True)
        return out

    def _load_op(self, session_id: str) -> Optional[SessionState]:
        gens = self._committed(self._dir(session_id))
        if not gens:
            return None
        t0 = self._clock()
        failures: List[Tuple[int, Exception]] = []
        for gen in reversed(gens):
            try:
                state = self._load_gen(session_id, gen)
            except SessionIdentityError:
                raise  # other weights: no older generation can help
            except Exception as e:  # a damaged payload surfaces as many types
                failures.append((gen, e))
                warnings.warn(f"session {session_id} generation {gen} is corrupt or incomplete "
                              f"({type(e).__name__}: {str(e)[:200]}); falling back to the "
                              "previous generation", stacklevel=2)
                continue
            if failures:
                warnings.warn(f"restored session {session_id} from generation {gen} after "
                              f"skipping {[g for g, _ in failures]}", stacklevel=2)
            self._observe("load", t0)
            return state
        os_errs = [e for _, e in failures if isinstance(e, OSError)]
        if os_errs:
            raise os_errs[-1]
        raise SessionIntegrityError(
            f"no intact generation for session {session_id}; tried "
            + ", ".join(f"{g} ({type(e).__name__})" for g, e in failures)) from failures[-1][1]

    def _load_gen(self, session_id: str, gen: int) -> SessionState:
        d = self._dir(session_id)

        def _read():
            fire("serve.session_load", step=gen)
            with self._io_open(self._json(d, gen)) as f:
                doc = json.load(f)
            with self._io_open(self._bin(d, gen), "rb") as f:
                blob = f.read()
            return doc, blob

        doc, blob = call_with_retries(_read, self._retry,
                                      describe=f"session load ({session_id} gen {gen})",
                                      should_abort=self._should_abort)
        saved = doc.get("identity")
        if self.identity is not None and saved is not None and saved != self.identity:
            raise SessionIdentityError(
                f"session {session_id} gen {gen} was suspended under weights identity "
                f"{saved!r} but this server runs {self.identity!r}: resuming cross-checkpoint "
                "or cross-qmode state would silently diverge (same shapes, wrong numbers)")
        manifest = doc["manifest"]
        leaves = _leaves_from(manifest, blob, f"session {session_id} gen {gen}",
                              SessionIntegrityError)
        payload = _decode_tree(doc["structure"], leaves)
        verify_manifest(payload, manifest)  # shapes, dtypes, crc32, leaf by leaf
        return SessionState(
            session_id=session_id, seed=int(doc["seed"]), sample=SampleConfig(**doc["sample"]),
            served=int(doc["served"]), token=payload["token"].numpy(), state=payload["state"],
            t=payload["t"].numpy(), emit=payload["emit"].numpy(), done=payload["done"].numpy(),
            prompt=payload["prompt"].numpy(), emitted=payload["emitted"].numpy(), generation=gen)

    def delete(self, session_id: str) -> None:
        self._delete_dir(self._dir(session_id))


__all__ = ["SessionStore", "SessionState", "SessionIntegrityError", "SessionIdentityError"]
