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
are synchronous. The reference's I/O retries and fault-injection hooks
(``resilience/``) are not ported yet (ROADMAP.md queue A, item 9).
"""

from __future__ import annotations

import json
import os
import re
import warnings
import zlib
from typing import Any, Dict, List, Mapping, Optional

import torch

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


def _leaves(tree: Mapping[str, Any], prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def _crc32(t: torch.Tensor) -> int:
    raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return int(zlib.crc32(raw.numpy().tobytes()))


def build_manifest(state: Mapping[str, Any], step: int) -> Dict[str, Any]:
    """Per-leaf path, shape, dtype and crc32 of the bytes, for a nested dict
    of tensors."""
    leaves = [
        {"path": path, "shape": list(t.shape), "dtype": str(t.dtype).removeprefix("torch."),
         "crc32": _crc32(t)}
        for path, t in _leaves(state)
    ]
    return {"version": MANIFEST_VERSION, "step": int(step), "n_leaves": len(leaves),
            "leaves": leaves}


def verify_manifest(state: Mapping[str, Any], manifest: Dict[str, Any]) -> None:
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


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3, save_every: int = 1000):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_every = save_every
        self._manifest_dir = os.path.join(self.directory, MANIFEST_DIRNAME)
        os.makedirs(self._manifest_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step:08d}.pt")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._manifest_dir, f"manifest-{step}.json")

    def all_steps(self) -> List[int]:
        return sorted(
            int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory)) if m
        )

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------

    def maybe_save(self, step: int, state: Mapping[str, Any], force: bool = False) -> bool:
        """Save at the cadence (``step % save_every == 0``) or when forced;
        a step already on disk is not written again. Returns whether it
        saved."""
        if not force and (self.save_every <= 0 or step % self.save_every != 0):
            return False
        if step in self.all_steps():
            return False
        cpu = _to_cpu(state)
        tmp = self._path(step) + ".tmp"
        torch.save(cpu, tmp)
        os.replace(tmp, self._path(step))
        atomic_write_json(self._manifest_path(step), build_manifest(cpu, step))
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
        back: corruption there raises."""
        if step is not None:
            return self._restore_step(step, map_location)
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        failures = []
        for s in steps:
            try:
                state = self._restore_step(s, map_location)
            except Exception as e:  # a torn or corrupt file surfaces as many types
                failures.append((s, e))
                warnings.warn(f"checkpoint step {s} is corrupt or incomplete "
                              f"({type(e).__name__}: {str(e)[:200]}); falling back to the "
                              "next retained step", stacklevel=2)
                continue
            if failures:
                warnings.warn(f"restored step {s} after skipping corrupt step(s) "
                              f"{[f[0] for f in failures]}", stacklevel=2)
            return state
        raise CheckpointIntegrityError(
            f"no intact checkpoint in {self.directory}; tried "
            + ", ".join(f"{s} ({type(e).__name__})" for s, e in failures)
        ) from failures[-1][1]

    def _restore_step(self, step: int, map_location) -> Dict[str, Any]:
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        mpath = self._manifest_path(step)
        if not os.path.exists(mpath):
            warnings.warn(f"checkpoint step {step} has no integrity manifest; "
                          "restoring unverified", stacklevel=2)
        else:
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
            except (OSError, ValueError) as e:
                raise CheckpointIntegrityError(f"step {step}: manifest unreadable ({e})") from e
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
    "atomic_write_json",
]
