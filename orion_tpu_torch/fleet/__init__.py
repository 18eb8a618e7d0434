"""Fleet: a replicated front door that turns "a server" into "a service". The
port's counterpart of ``orion_tpu/fleet/``.

The O(1) recurrent decode state is what makes this layer thin: a
conversation is one small state on a SHARED session store, so any replica
can resume any session from disk; replication needs a router, not a cache
fabric. The pieces:

- :mod:`replica` -- :class:`ReplicaHandle` transports: a
  :class:`ProcessReplica` runs a whole ``serving.Server`` in a child OS
  process behind a line-delimited JSON control channel (SIGTERM = drain,
  sessions suspend to the shared store); a :class:`LocalReplica` drives the
  same server on a thread (tests, ``--local``).
- :mod:`router` -- :class:`Router`: least-loaded dispatch that routes around
  DEGRADED / DRAINING / DEAD replicas, sheds with ``OverloadError`` at the
  fleet admission bound, fails over when a replica's channel breaks, and
  serializes turns per conversation fleet-wide.
- :mod:`supervisor` -- :class:`Supervisor`: heartbeats, degraded =>
  SIGTERM-drain-and-respawn, exit => respawn, spawn retries, respawn held
  back through a store outage; opt-in autoscaling
  (:class:`AutoscalePolicy`) over queue depth, capacity headroom and SLO
  burn.

``python -m orion_tpu_torch.fleet`` is the CLI.
"""

from orion_tpu_torch.fleet.replica import (FleetPending, LocalReplica, ProcessReplica, ReplicaGone,
                                           ReplicaHandle, ReplicaSpec)
from orion_tpu_torch.fleet.router import Router
from orion_tpu_torch.fleet.supervisor import AutoscalePolicy, Supervisor

__all__ = [
    "AutoscalePolicy", "FleetPending", "LocalReplica", "ProcessReplica",
    "ReplicaGone", "ReplicaHandle", "ReplicaSpec", "Router", "Supervisor",
]
