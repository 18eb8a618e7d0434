"""Serving: the port's counterpart of ``orion_tpu/serving/``. Ported so far:
the single-request ``DecodeSession`` (chunked decode with snapshots, the
finite probe and the degradation ladder), the parity oracle of the
slot-multiplexed engine. ``SlotEngine``, ``Server``, the CLI, the stores
and speculative decode follow (ROADMAP.md A8)."""

from orion_tpu_torch.serving.session import (DecodeRequest, DecodeResult, DecodeSession,
                                             LadderExhausted)

__all__ = ["DecodeRequest", "DecodeResult", "DecodeSession", "LadderExhausted"]
