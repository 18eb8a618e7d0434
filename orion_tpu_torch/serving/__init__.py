"""Serving: the port's counterpart of ``orion_tpu/serving/``.

- :mod:`batching` -- :class:`SlotEngine`: slot-multiplexed continuous
  batching (admission and eviction at chunk boundaries, in-scan prefill, the
  per-slot degradation ladder, session suspend and resume).
- :mod:`session` -- :class:`DecodeSession`: single-request chunked decode
  with snapshots, the finite probe and the degradation ladder.
- :mod:`server` -- :class:`Server`: the scheduler loop over the engine:
  bounded admission with shedding, request isolation, watchdog heartbeats,
  SIGTERM -> drain (finish in-flight and queued, reject new, exit 0), and
  its metrics, traces and flight recorder.
- :mod:`health` -- the validated STARTING -> SERVING <-> DEGRADED ->
  DRAINING -> DEAD health state machine.
- :mod:`locks` -- the declared lock hierarchy (data).

``python -m orion_tpu_torch.serving`` is the CLI. The stores and speculative
decode follow (ROADMAP.md A8 steps 3-4).
"""

from orion_tpu_torch.serving.batching import SlotEngine, parse_buckets
from orion_tpu_torch.serving.health import Health, HealthMachine, InvalidTransition
from orion_tpu_torch.serving.server import (OverloadError, Pending, RejectedError, ServeConfig,
                                            Server, load_tokenizer)
from orion_tpu_torch.serving.session import (DecodeRequest, DecodeResult, DecodeSession,
                                             LadderExhausted)
from orion_tpu_torch.serving.session_store import SessionState

__all__ = ["Health", "HealthMachine", "InvalidTransition", "Server", "ServeConfig", "Pending",
           "OverloadError", "RejectedError", "load_tokenizer", "SlotEngine", "parse_buckets",
           "DecodeRequest", "DecodeResult", "DecodeSession", "LadderExhausted", "SessionState"]
