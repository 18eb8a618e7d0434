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
- :mod:`session_store` -- :class:`SessionStore`: durable sessions,
  generation-numbered, manifested and crc-checked, stamped with the weights'
  identity.
- :mod:`prefix_store` -- :class:`PrefixStore`: the content-addressed prefix
  cache (a hit admits at O(suffix)).
- :mod:`health` -- the validated STARTING -> SERVING <-> DEGRADED ->
  DRAINING -> DEAD health state machine.
- :mod:`locks` -- the declared lock hierarchy (data).

``python -m orion_tpu_torch.serving`` is the CLI. Speculative decode follows
(ROADMAP.md A8 step 4).
"""

from orion_tpu_torch.serving.batching import SlotEngine, parse_buckets
from orion_tpu_torch.serving.health import Health, HealthMachine, InvalidTransition
from orion_tpu_torch.serving.prefix_store import (PrefixEntry, PrefixStore, overrides_fingerprint,
                                                  params_identity)
from orion_tpu_torch.serving.server import (OverloadError, Pending, RejectedError, ServeConfig,
                                            Server, load_tokenizer)
from orion_tpu_torch.serving.session import (DecodeRequest, DecodeResult, DecodeSession,
                                             LadderExhausted)
from orion_tpu_torch.serving.session_store import (SessionIdentityError, SessionIntegrityError,
                                                   SessionState, SessionStore)

__all__ = ["Health", "HealthMachine", "InvalidTransition", "Server", "ServeConfig", "Pending",
           "OverloadError", "RejectedError", "load_tokenizer", "SlotEngine", "parse_buckets",
           "DecodeRequest", "DecodeResult", "DecodeSession", "LadderExhausted", "SessionState",
           "SessionStore", "SessionIntegrityError", "SessionIdentityError", "PrefixStore",
           "PrefixEntry", "params_identity", "overrides_fingerprint"]
