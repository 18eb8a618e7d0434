"""Serving: the port's counterpart of ``orion_tpu/serving/``. Ported so far:
the single-request ``DecodeSession`` (chunked decode with snapshots, the
finite probe and the degradation ladder) and ``SlotEngine``, the slot
scheduler that multiplexes requests onto the slot programs (continuous
batching, in-scan admission, the per-slot ladder, session suspend and
resume). ``Server``, the CLI, the stores and speculative decode follow
(ROADMAP.md A8 steps 2-4).
"""

from orion_tpu_torch.serving.batching import SlotEngine, parse_buckets
from orion_tpu_torch.serving.session import (DecodeRequest, DecodeResult, DecodeSession,
                                             LadderExhausted)
from orion_tpu_torch.serving.session_store import SessionState

__all__ = ["DecodeRequest", "DecodeResult", "DecodeSession", "LadderExhausted", "SessionState",
           "SlotEngine", "parse_buckets"]
