"""Checkpoints for the port's trainer: atomic writes, integrity manifests,
retention, and a fallback to the newest intact step.

The torch-native counterpart of ``orion_tpu/training/checkpoint.py`` (no
orbax). A state is a nested dict whose leaves are tensors (the trainer's
``state_dict``: params, optimizer state, step, rng seed, non-finite count).
Each save writes

- ``step-<N>.pt`` (``torch.save``), to a temporary name then
  ``os.replace``d into place, so a reader or a restart after a kill mid-write
  sees either no step N or all of it;
- ``manifests/manifest-<N>.json`` beside it, atomically: every leaf's path,
  shape, dtype and crc32 of its bytes (``build_manifest``).

``restore`` re-checksums what it loaded against the manifest
(``verify_manifest``); with no step pinned it falls back, with a warning, to
the newest step that loads and verifies. A pinned step never falls back.
Retention keeps the newest ``max_to_keep`` steps and their manifests. Saves
are synchronous.

``load_params`` is the serving side's restore, the counterpart of
``orion_tpu/generate.py::load_params``: just the ``params`` subtree of a
step, memory-mapped (an optimizer state beside it is never read), verified
against the manifest's ``params/...`` leaves, with I/O retried
(``resilience/retry.py``) and the same fallback policy. Its read fires the
``serve.ckpt_load`` fault hook (``resilience/inject.py``) inside the retried
region, so a chaos test drives the real retry path.

The training side's saves and restores are retried the same way
(``Checkpointer(retry=)``, default ``RetryPolicy()``) and fire ``ckpt.save``
/ ``ckpt.restore`` inside their retried regions. A save at a step already on
disk is skipped (an emergency save at a step the cadence just wrote stays
idempotent), except when that step failed verification during a fallback
restore of this ``Checkpointer``: the known-bad file is then deleted and the
good state takes its place, so an "emergency checkpoint saved" message is
never false.
"""

from __future__ import annotations

import json
import os
import re
import warnings
import zlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from orion_tpu_torch.resilience.inject import fire
from orion_tpu_torch.resilience.retry import RetryPolicy, call_with_retries

MANIFEST_DIRNAME = "manifests"
MANIFEST_VERSION = 1
_STEP_FILE = re.compile(r"^step-(\d+)\.pt$")


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint step failed manifest verification (or has an unreadable
    manifest): structure, shape/dtype, or content checksum mismatch."""


def atomic_write_json(path: str, payload: Dict[str, Any]) -> None:
    """Write a JSON file atomically: a sibling ``.tmp``, then ``os.replace``."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _leaves(tree: Any, prefix: str = ""):
    """(path, leaf) of a nested dict (keys sorted) whose values may also be
    lists or tuples (walked in order, their index a path component): a
    session's per-layer state is a list of dicts."""
    items = (sorted(tree.items()) if isinstance(tree, Mapping)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (Mapping, list, tuple)):
            yield from _leaves(v, path)
        else:
            yield path, _as_tensor(v)


def _as_tensor(leaf: Any) -> torch.Tensor:
    """A leaf as a tensor: a numpy array (a session's host bookkeeping) is
    viewed, not copied."""
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))


def _crc32(t: torch.Tensor) -> int:
    return int(zlib.crc32(tensor_bytes(t)))


def tensor_bytes(t: torch.Tensor) -> bytes:
    """A tensor's bytes, C order (a bfloat16 tensor's as its 16-bit words:
    numpy has no bfloat16)."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def build_manifest(state: Any, step: int) -> Dict[str, Any]:
    """Per-leaf path, shape, dtype and crc32 of the bytes, for a nested dict
    (or list) of tensors or numpy arrays."""
    leaves = [
        {"path": path, "shape": list(t.shape), "dtype": str(t.dtype).removeprefix("torch."),
         "crc32": _crc32(t)}
        for path, t in _leaves(state)
    ]
    return {"version": MANIFEST_VERSION, "step": int(step), "n_leaves": len(leaves),
            "leaves": leaves}


def verify_manifest(state: Any, manifest: Dict[str, Any]) -> None:
    """Raise :class:`CheckpointIntegrityError` unless ``state`` matches the
    manifest leaf for leaf (paths, shapes, dtypes, content checksums)."""
    expected = {e["path"]: e for e in manifest.get("leaves", ())}
    problems: List[str] = []
    seen = set()
    for path, t in _leaves(state):
        seen.add(path)
        e = expected.get(path)
        if e is None:
            problems.append(f"unexpected leaf {path}")
        elif list(t.shape) != e["shape"] or str(t.dtype).removeprefix("torch.") != e["dtype"]:
            problems.append(f"{path}: shape/dtype {tuple(t.shape)}/{t.dtype} != manifest "
                            f"{tuple(e['shape'])}/{e['dtype']}")
        elif _crc32(t) != e["crc32"]:
            problems.append(f"{path}: content checksum mismatch")
    missing = set(expected) - seen
    if missing:
        problems.append(f"missing leaves: {sorted(missing)[:3]}")
    if problems:
        more = f" (+{len(problems) - 5} more)" if len(problems) > 5 else ""
        raise CheckpointIntegrityError(
            f"step {manifest.get('step')}: {'; '.join(problems[:5])}{more}"
        )


def step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step-{step:08d}.pt")


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, MANIFEST_DIRNAME, f"manifest-{step}.json")


def all_steps(directory: str) -> List[int]:
    """The steps with a ``step-<N>.pt`` file in ``directory``, ascending."""
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(directory)) if m)


def read_manifest(directory: str, step: int) -> Optional[Dict[str, Any]]:
    """Step ``step``'s manifest, or None when it has none; an unreadable one
    raises :class:`CheckpointIntegrityError`."""
    path = manifest_path(directory, step)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(f"step {step}: manifest unreadable ({e})") from e


def manifest_subtree(manifest: Dict[str, Any], prefix: str) -> Optional[Dict[str, Any]]:
    """The manifest of one subtree (``state[prefix]``), its leaf paths
    re-rooted so that the subtree on its own verifies against it: the port's
    counterpart of ``orion_tpu/training/checkpoint.py::manifest_subtree``.
    None when the manifest has no leaf under ``prefix``."""
    head = prefix + "/"
    leaves = [dict(e, path=e["path"][len(head):]) for e in manifest.get("leaves", ())
              if e["path"].startswith(head)]
    if not leaves:
        return None
    return {**manifest, "leaves": leaves, "n_leaves": len(leaves)}


def _newest_intact(directory: str, steps: List[int], load: Callable[[int], Any],
                   what: str, failed: Optional[set] = None) -> Tuple[Any, int]:
    """``load(s)`` of the newest of ``steps`` that loads and verifies,
    warning for each one skipped (and adding it to ``failed``); raises when
    none does."""
    failures = []
    for s in sorted(steps, reverse=True):
        try:
            out = load(s)
        except Exception as e:  # a torn or corrupt file surfaces as many types
            failures.append((s, e))
            if failed is not None:
                failed.add(s)
            warnings.warn(f"checkpoint step {s} is corrupt or incomplete "
                          f"({type(e).__name__}: {str(e)[:200]}); {what} falls back to the "
                          "next retained step", stacklevel=3)
            continue
        if failures:
            warnings.warn(f"{what} from step {s} after skipping corrupt step(s) "
                          f"{[f[0] for f in failures]}", stacklevel=3)
        return out, s
    if not failures:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    raise CheckpointIntegrityError(
        f"no intact checkpoint in {directory}; tried "
        + ", ".join(f"{s} ({type(e).__name__})" for s, e in failures)
    ) from failures[-1][1]


def _load_step_params(directory: str, step: int, retry: RetryPolicy, verify: bool):
    def load():
        fire("serve.ckpt_load", step=step)
        # memory-mapped: only the params' bytes are read, when verified or
        # copied to the device
        return torch.load(step_path(directory, step), map_location="cpu", weights_only=True,
                          mmap=True)

    state = call_with_retries(load, retry, describe=f"param load (step {step})")
    params = state["params"]
    if verify:
        manifest = read_manifest(directory, step)
        sub = None if manifest is None else manifest_subtree(manifest, "params")
        if sub is None:
            warnings.warn(f"checkpoint step {step} has no params integrity manifest; "
                          "serving it unverified", stacklevel=3)
        else:
            verify_manifest(params, sub)
    return params


def load_params(ckpt_dir: str, step: Optional[int] = None, retry: Optional[RetryPolicy] = None,
                verify: bool = True) -> Tuple[Dict[str, torch.Tensor], int]:
    """The ``params`` subtree of a checkpoint step (CPU tensors, memory-
    mapped) and its step number: a default-latest load falls back, with a
    warning, to the newest intact step when the latest is torn or corrupt;
    a pinned ``step`` never falls back. File reads are retried under
    ``retry`` (default ``RetryPolicy()``: OSError only, jittered backoff);
    the params are re-checksummed against the step's manifest unless
    ``verify`` is False."""
    directory = os.path.abspath(ckpt_dir)
    policy = retry if retry is not None else RetryPolicy()
    if step is not None:
        return _load_step_params(directory, step, policy, verify), step
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return _newest_intact(directory, all_steps(directory),
                          lambda s: _load_step_params(directory, s, policy, verify),
                          "serving params")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3, save_every: int = 1000,
                 retry: Optional[RetryPolicy] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_every = save_every
        self._retry = retry if retry is not None else RetryPolicy()
        # steps that failed verification in a fallback restore: a later save
        # there overwrites the known-bad file instead of being skipped
        self._corrupt_steps: set = set()
        os.makedirs(os.path.join(self.directory, MANIFEST_DIRNAME), exist_ok=True)

    def _path(self, step: int) -> str:
        return step_path(self.directory, step)

    def _manifest_path(self, step: int) -> str:
        return manifest_path(self.directory, step)

    def all_steps(self) -> List[int]:
        return all_steps(self.directory)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------

    def due(self, step: int, force: bool = False) -> bool:
        """Is ``step`` at the cadence (``step % save_every == 0``), or
        forced? (What ``maybe_save`` asks before it looks at the disk.)"""
        return force or (self.save_every > 0 and step % self.save_every == 0)

    def maybe_save(self, step: int, state: Mapping[str, Any], force: bool = False) -> bool:
        """Save at the cadence (``due``); a step already on disk is not
        written again unless it failed verification in a restore of this
        Checkpointer (it is then replaced). The write and the manifest are
        retried under the Checkpointer's policy. Returns whether it saved."""
        if not self.due(step, force):
            return False
        if step in self._corrupt_steps:
            # the file on disk failed verification: this (good) state takes
            # its place
            self._corrupt_steps.discard(step)
            for path in (self._path(step), self._manifest_path(step)):
                if os.path.exists(path):
                    os.remove(path)
        if step in self.all_steps():
            return False
        cpu = _to_cpu(state)
        manifest = build_manifest(cpu, step)

        def save():
            fire("ckpt.save", step=step)
            tmp = self._path(step) + ".tmp"
            torch.save(cpu, tmp)
            os.replace(tmp, self._path(step))

        call_with_retries(save, self._retry, describe=f"checkpoint save (step {step})")
        call_with_retries(lambda: atomic_write_json(self._manifest_path(step), manifest),
                          self._retry, describe=f"checkpoint manifest (step {step})")
        self._retain()
        return True

    def _retain(self) -> None:
        steps = self.all_steps()
        for old in steps[: max(0, len(steps) - self.max_to_keep)]:
            for path in (self._path(old), self._manifest_path(old)):
                if os.path.exists(path):
                    os.remove(path)

    # -- restore -------------------------------------------------------------

    def restore(self, step: Optional[int] = None, map_location=None) -> Dict[str, Any]:
        """The state at ``step`` (default: the newest intact one), verified
        against its manifest. An explicitly requested step never falls
        back: corruption there raises. A step skipped in the fallback is
        remembered, so a later save at it overwrites it."""
        if step is not None:
            return self._restore_step(step, map_location)
        state, _ = _newest_intact(self.directory, self.all_steps(),
                                  lambda s: self._restore_step(s, map_location), "restore",
                                  failed=self._corrupt_steps)
        return state

    def _restore_step(self, step: int, map_location) -> Dict[str, Any]:
        def load():
            fire("ckpt.restore", step=step)
            return torch.load(self._path(step), map_location="cpu", weights_only=True)

        state = call_with_retries(load, self._retry, describe=f"checkpoint restore (step {step})")
        manifest = read_manifest(self.directory, step)
        if manifest is None:
            warnings.warn(f"checkpoint step {step} has no integrity manifest; "
                          "restoring unverified", stacklevel=2)
        else:
            verify_manifest(state, manifest)
        return _to_device(state, map_location) if map_location is not None else state


def _to_cpu(tree):
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _to_device(tree, device):
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


__all__ = [
    "Checkpointer", "CheckpointIntegrityError", "build_manifest", "verify_manifest",
    "atomic_write_json", "load_params", "manifest_subtree", "read_manifest",
]
