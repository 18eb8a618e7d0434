"""Config overrides for the CLIs' ``--set KEY=VALUE`` and ``--config-json``
flags.

The port's copy of ``orion_tpu/utils/config.py``: ``apply_overrides(cfg,
{"n_layers": 4})`` returns a new frozen dataclass with dotted-path fields
replaced; values are coerced to the field's existing type. JSON override
files are dicts of the same dotted (or nested) form."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping


def _coerce(old: Any, new: Any) -> Any:
    if old is None or new is None:
        return new
    if isinstance(old, bool):
        if isinstance(new, str):
            return new.lower() in ("1", "true", "yes")
        return bool(new)
    if isinstance(old, int):
        return int(new)
    if isinstance(old, float):
        return float(new)
    if isinstance(old, tuple) and isinstance(new, (list, tuple)):
        return tuple(new)
    return new


def _flatten(d: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def apply_overrides(cfg: Any, overrides: Mapping[str, Any]) -> Any:
    """Return cfg with dotted-path overrides applied (recursively)."""
    grouped: Dict[str, Dict[str, Any]] = {}
    direct: Dict[str, Any] = {}
    for k, v in _flatten(dict(overrides)).items():
        if "." in k:
            head, rest = k.split(".", 1)
            grouped.setdefault(head, {})[rest] = v
        else:
            direct[k] = v

    fields = {f.name for f in dataclasses.fields(cfg)}
    updates: Dict[str, Any] = {}
    for k in list(direct) + list(grouped):
        if k not in fields:
            raise KeyError(f"{type(cfg).__name__} has no field {k!r}")
    for k, v in direct.items():
        updates[k] = _coerce(getattr(cfg, k), v)
    for head, sub in grouped.items():
        updates[head] = apply_overrides(getattr(cfg, head), sub)
    return dataclasses.replace(cfg, **updates)


def load_json_overrides(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def parse_set_overrides(pairs) -> Dict[str, Any]:
    """['k=v', ...] (the CLIs' repeated --set flag) -> override mapping."""
    overrides: Dict[str, Any] = {}
    for kv in pairs:
        k, sep, v = kv.partition("=")
        if not sep or not k:
            raise ValueError(f"--set expects KEY=VALUE, got {kv!r}")
        overrides[k] = v
    return overrides


__all__ = ["apply_overrides", "load_json_overrides", "parse_set_overrides"]
