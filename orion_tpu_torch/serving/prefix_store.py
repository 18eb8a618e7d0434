"""Content-addressed prefix store: shared prompt prefixes as O(1) snapshots.
The port's counterpart of ``orion_tpu/serving/prefix_store.py``.

The decode state after prefilling the first ``L`` tokens of a prompt is one
fixed-size (S, z)-plus-caches row, whatever ``L``, so a prefix cache entry is
one such snapshot plus the tokens it was built from, and a hit turns
O(prompt) admission into O(suffix): the cached row is staged at position
``L`` and the in-scan prefill consumes only the uncached tail
(``SlotEngine._stage_prefix``).

Addressing is by CONTENT: the key is ``sha256(params_id | qmode | the int32
bytes of prompt[:L])``, byte for byte the JAX package's, so every replica
sharing a ``prefix_dir`` resolves the same system prompt to the same entry
with no registry; other weights or another quantization mode never collide.
``params_id`` names the weights (config, checkpoint step or init seed): the
Server derives a config-hash default (:func:`params_identity`) and the CLI
pins the checkpoint.

Alignment: entries are published only at multiples of ``align`` (the
linear-attention chunk), because the in-scan pieces replay the monolithic
prefill only with every piece boundary on a chunk boundary. A lookup probes
the aligned prefix lengths longest first; each probe is one sha256 and one
directory listing, on the host.

Durability as the session store's (``gen-%06d.bin`` + ``.json`` under
``directory/<key>/``, the manifest rename the commit point, per-leaf crc32
on load, retries through the ``serve.prefix_save`` / ``serve.prefix_load``
hooks), with two differences:

- **every load failure degrades to a MISS** -- a corrupt or torn entry
  means a cold prefill, never a failed request (a prefix can be recomputed
  from the prompt; a conversation's state cannot);
- **racing publishers converge** -- nothing serializes prefix writers, so
  tmp files carry a per-process unique suffix and the last ``os.replace``
  wins with the same bytes (the state is a function of params, qmode and
  tokens).

The layout is the session store's, so ``inject.corrupt_session`` /
``truncate_session`` damage a prefix entry with its key for the id.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import uuid
import warnings
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from orion_tpu_torch.resilience.breaker import CircuitBreaker, StoreUnavailableError
from orion_tpu_torch.resilience.inject import fire
from orion_tpu_torch.resilience.retry import RetryPolicy, call_with_retries
from orion_tpu_torch.serving.session_store import (_BreakerIO, _blob, _decode_tree,
                                                   _encode_tree, _leaves_from)
from orion_tpu_torch.training.checkpoint import build_manifest, verify_manifest

PREFIX_FORMAT_VERSION = 1


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: the tokens it covers, the decode state after
    prefilling exactly those tokens (batch 1, CPU tensors), and the position
    ``t == tokens.shape[1]`` the state sits at."""

    key: str
    tokens: np.ndarray  # [1, L] int32
    state: Any  # per-layer decode state, batch 1
    t: int
    generation: int = 0


def overrides_fingerprint(overrides: Any) -> str:
    """A stable short hash of a ModelConfig override mapping (the CLI's
    parsed ``--set`` values): the one definition every params-id derivation
    uses, so two entry points serving the same weights share prefix
    entries."""
    doc = json.dumps(dict(overrides or {}), sort_keys=True, default=str)
    return hashlib.sha256(doc.encode()).hexdigest()[:8]


def params_identity(model_cfg: Any, qmode: str, extra: str = "") -> str:
    """The config-hash default ``params_id``: stable across processes for the
    same ModelConfig and qmode, and equal to the JAX package's for the same
    configuration. ``extra`` pins the weights' provenance (checkpoint step,
    init seed): a caller serving real checkpoints must supply it, or two
    checkpoints of one config share a namespace."""
    cfg_json = json.dumps(dataclasses.asdict(model_cfg), sort_keys=True, default=str)
    h = hashlib.sha256(f"{cfg_json}|{qmode}|{extra}".encode()).hexdigest()[:16]
    return f"cfg-{h}"


class PrefixStore(_BreakerIO):
    """Content-addressed prefix snapshots under ``directory/<key>/``.

    ``align``: candidate prefix lengths are its multiples (the engine's
    linear-attention chunk). ``max_probes`` bounds a lookup's candidate walk
    (longest first). ``observer``: host-only telemetry ``(op, ms, nbytes)``,
    op "load" or "save", after each completed store I/O. ``breaker``: the
    store's circuit breaker (an open one makes a lookup an instant miss)."""

    _STORE = "prefix"
    _SCAN_SITE = "serve.prefix_scan"

    def __init__(self, directory: str, params_id: str, qmode: str = "off", align: int = 1,
                 keep: int = 2, retry: Optional[RetryPolicy] = None,
                 should_abort: Optional[Callable[[], bool]] = None,
                 observer: Optional[Callable[[str, float, int], None]] = None,
                 clock: Callable[[], float] = time.monotonic, max_probes: int = 64,
                 breaker: Optional[CircuitBreaker] = None):
        if align < 1:
            raise ValueError(f"align must be >= 1, got {align}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        super().__init__(breaker)
        self.directory = os.path.abspath(directory)
        self.params_id = str(params_id)
        self.qmode = str(qmode or "off")
        self.align = int(align)
        self.keep = int(keep)
        self.max_probes = int(max_probes)
        self._retry = retry if retry is not None else RetryPolicy()
        self._should_abort = should_abort
        self._observer = observer
        self._clock = clock
        os.makedirs(self.directory, exist_ok=True)

    def _observe(self, op: str, t0: float, nbytes: int) -> None:
        if self._observer is not None:
            try:
                self._observer(op, (self._clock() - t0) * 1e3, nbytes)
            except Exception:
                pass  # telemetry must never fail the I/O it measures

    # -- keys and paths ---------------------------------------------------------------

    def key_for(self, tokens: Any) -> str:
        """The content hash of one aligned prefix: params identity, qmode and
        the tokens' int32 bytes, nothing else."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()
        h = hashlib.sha256()
        h.update(b"orion-prefix-v1|")
        h.update(self.params_id.encode())
        h.update(b"|")
        h.update(self.qmode.encode())
        h.update(b"|")
        h.update(toks)
        return h.hexdigest()[:32]

    def _dir(self, key: str) -> str:
        return os.path.join(self.directory, key)

    def generations(self, key: str) -> List[int]:
        """COMMITTED generations of one entry, oldest first. Raises
        ``StoreUnavailableError`` without a syscall while the breaker is
        open."""
        return self._committed(self._dir(key))

    def list_keys(self) -> List[str]:
        return sorted(n for n in self._io_listdir(self.directory) if self.generations(n))

    # -- candidates -------------------------------------------------------------------

    def candidate_lengths(self, prompt_len: int, declared: int = 0) -> List[int]:
        """Aligned prefix lengths to probe, longest first, at most
        ``max_probes``. A candidate leaves at least ONE suffix token: the
        hit's first token is drawn from the suffix piece's last real row.
        ``declared`` (the request's ``prefix_len``) is probed FIRST, so a
        declared system prompt hits however long the suffix is."""
        top = (prompt_len - 1) // self.align * self.align
        out = []
        if declared > 0:
            hint = self.publish_length(prompt_len, declared)
            if hint > 0:
                out.append(hint)
        length = top
        while length >= self.align and len(out) < self.max_probes:
            if length not in out:
                out.append(length)
            length -= self.align
        return out

    def publish_length(self, prompt_len: int, declared: int) -> int:
        """The aligned length a declared prefix publishes at: the largest
        multiple of ``align`` <= min(declared, prompt_len - 1), or 0."""
        usable = min(int(declared), prompt_len - 1)
        if usable < self.align:
            return 0
        return usable // self.align * self.align

    # -- lookup -----------------------------------------------------------------------

    def lookup(self, prompt: Any, declared: int = 0) -> Optional[PrefixEntry]:
        """The longest cached aligned prefix of ``prompt`` (the declared
        length probed first), or None. Damage of any kind (an unreadable
        file, a crc mismatch, a collision's token mismatch) degrades to the
        next generation, then the next candidate, then a miss: the request
        never fails here. An OPEN breaker is an instant miss (one ``allow``
        and no disk probe); one completed walk is one breaker sample."""
        toks = np.asarray(prompt, np.int32).reshape(1, -1)
        lengths = self.candidate_lengths(toks.shape[1], declared)
        if not lengths:
            return None
        if self.breaker is not None and not self.breaker.allow():
            return None  # open: a cold prefill, fail-fast
        try:
            entry, os_fail, aborted = self._lookup_walk(toks, lengths)
        except BaseException:
            self._exit(False, "lookup: aborted")
            raise
        if aborted:
            return None  # the breaker tripped under the walk: a miss, no sample
        if os_fail is not None:
            self._exit(False, f"lookup: {type(os_fail).__name__}")
        else:
            self._exit(True)
        return entry

    def _lookup_walk(self, toks: np.ndarray, lengths: List[int]
                     ) -> Tuple[Optional[PrefixEntry], Optional[OSError], bool]:
        """-> (entry, the first OSError seen, aborted by an open breaker);
        no store error escapes."""
        os_fail: Optional[OSError] = None
        for length in lengths:
            prefix = toks[:, :length]
            key = self.key_for(prefix)
            try:
                gens = self.generations(key)
            except StoreUnavailableError:
                return None, None, True
            except OSError as e:
                os_fail = e
                continue
            if not gens:
                continue
            t0 = self._clock()
            for gen in reversed(gens):
                try:
                    entry, nbytes = self._load_gen(key, gen)
                except StoreUnavailableError:
                    return None, None, True
                except OSError as e:  # store-shaped: counts as evidence
                    os_fail = e
                    warnings.warn(f"prefix {key} generation {gen} is unreadable "
                                  f"({type(e).__name__}: {str(e)[:200]}); trying the previous "
                                  "generation", stacklevel=2)
                    continue
                except Exception as e:  # a damaged payload: many types
                    warnings.warn(f"prefix {key} generation {gen} is corrupt or incomplete "
                                  f"({type(e).__name__}: {str(e)[:200]}); trying the previous "
                                  "generation", stacklevel=2)
                    continue
                if (entry.t != length or entry.tokens.shape != prefix.shape
                        or not np.array_equal(entry.tokens, prefix)):
                    # a key collision: the stored tokens are the truth
                    warnings.warn(f"prefix {key} gen {gen} does not match the probed tokens; "
                                  "ignoring the entry", stacklevel=2)
                    continue
                self._observe("load", t0, nbytes)
                return entry, os_fail, False
        return None, os_fail, False

    def _load_gen(self, key: str, gen: int) -> Tuple[PrefixEntry, int]:
        d = self._dir(key)

        def _read():
            fire("serve.prefix_load", step=gen)
            with self._io_open(self._json(d, gen)) as f:
                doc = json.load(f)
            with self._io_open(self._bin(d, gen), "rb") as f:
                blob = f.read()
            return doc, blob

        doc, blob = call_with_retries(_read, self._retry,
                                      describe=f"prefix load ({key} gen {gen})",
                                      should_abort=self._should_abort)
        if doc.get("params_id") != self.params_id or doc.get("qmode") != self.qmode:
            raise ValueError(f"prefix {key} gen {gen} was published for "
                             f"({doc.get('params_id')}, {doc.get('qmode')}), not "
                             f"({self.params_id}, {self.qmode})")
        manifest = doc["manifest"]
        payload = _decode_tree(doc["structure"],
                               _leaves_from(manifest, blob, f"prefix {key} gen {gen}"))
        verify_manifest(payload, manifest)  # shapes, dtypes, crc32, leaf by leaf
        # the blob's size, as the save side records it
        return PrefixEntry(key=key, tokens=payload["tokens"].numpy().astype(np.int32),
                           state=payload["state"], t=int(doc["t"]), generation=gen), len(blob)

    # -- publish ----------------------------------------------------------------------

    def publish(self, tokens: Any, state: Any, *, skip_if_present: bool = True
                ) -> Optional[int]:
        """Persist one prefix entry as a NEW generation -> its number, or None
        when skipped (``skip_if_present`` and an entry is committed).
        ``state`` may live on the card: it is copied to the host HERE, the
        store's one read of the card (the engine's admission path reads
        none). Raises ``StoreUnavailableError`` with no syscall while the
        breaker is open; one completed publish is one breaker sample."""
        toks = np.asarray(tokens, np.int32).reshape(1, -1)
        if toks.shape[1] % self.align != 0 or toks.shape[1] == 0:
            raise ValueError(f"prefix length {toks.shape[1]} is not a positive multiple of the "
                             f"alignment {self.align}: the in-scan pieces replay the prefill "
                             "only with piece boundaries on chunk boundaries")
        if self.breaker is not None and not self.breaker.allow():
            raise StoreUnavailableError(self._STORE)
        try:
            return self._publish_op(toks, state, skip_if_present)
        except StoreUnavailableError:
            raise
        except OSError as e:
            self._exit(False, f"publish: {type(e).__name__}")
            raise

    def _publish_op(self, toks: np.ndarray, state: Any, skip_if_present: bool
                    ) -> Optional[int]:
        key = self.key_for(toks)
        d = self._dir(key)
        gens = self.generations(key)
        if gens and skip_if_present:
            self._exit(True)  # the existence scan answered: the store is up
            return None
        gen = (gens[-1] if gens else 0) + 1
        payload = {"tokens": toks, "state": _host_tree(state)}
        leaves: List[torch.Tensor] = []
        structure = _encode_tree(payload, leaves)
        manifest = build_manifest(payload, gen)
        blob = _blob(manifest, leaves)
        doc = {"format": PREFIX_FORMAT_VERSION, "key": key, "params_id": self.params_id,
               "qmode": self.qmode, "align": self.align, "t": int(toks.shape[1]),
               "generation": gen, "structure": structure, "manifest": manifest}
        # per-process unique tmp names: racing writers each complete their
        # own tmp and converge by last-replace-wins on the same bytes
        nonce = f"{os.getpid():x}-{uuid.uuid4().hex[:8]}"

        def _write():
            fire("serve.prefix_save", step=gen)
            self._io_makedirs(d)
            tmp_bin = self._bin(d, gen) + f".tmp-{nonce}"
            with self._io_open(tmp_bin, "wb") as f:
                f.write(blob)
            self._io_replace(tmp_bin, self._bin(d, gen))
            tmp_json = self._json(d, gen) + f".tmp-{nonce}"
            with self._io_open(tmp_json, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            self._io_replace(tmp_json, self._json(d, gen))  # the commit point

        t0 = self._clock()
        call_with_retries(_write, self._retry, describe=f"prefix publish ({key} gen {gen})",
                          should_abort=self._should_abort)
        self._exit(True)
        self._observe("save", t0, len(blob))
        self._gc(d, keep_from=gen)
        return gen

    def _gc(self, d: str, keep_from: int) -> None:
        """Drop generations older than the newest ``keep`` and STALE tmp
        files (advisory). A tmp younger than a minute is left alone: a racing
        replica's in-flight tmp looks like a stranded one."""
        floor = keep_from - self.keep + 1
        now = time.time()
        try:
            names = self._io_listdir(d)
        except (OSError, StoreUnavailableError):
            return
        for name in names:
            path = os.path.join(d, name)
            try:
                if ".tmp-" in name:
                    if now - os.path.getmtime(path) > 60.0:
                        self._io_remove(path)
                    continue
                if not name.startswith("gen-"):
                    continue
                if int(name.split(".", 1)[0][len("gen-"):]) < floor:
                    self._io_remove(path)
            except (OSError, ValueError, StoreUnavailableError):
                continue

    def delete(self, key: str) -> None:
        self._delete_dir(self._dir(key))


def _host_tree(tree: Any) -> Any:
    """A decode state (dicts of tensors, in lists) copied to the host: the
    store's one read of the card, on the publish side only."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else np.asarray(tree)


__all__ = ["PrefixStore", "PrefixEntry", "params_identity", "overrides_fingerprint"]
