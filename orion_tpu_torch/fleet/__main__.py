"""``python -m orion_tpu_torch.fleet`` -- serve prompts through a replicated
fleet: the port's counterpart of ``orion_tpu/fleet/__main__.py``.

Spawns ``--replicas`` child serving processes (identical weights: the same
seeded init or the same ``--ckpt-dir``), routes prompts through the
least-loaded dispatcher, supervises heartbeats in the background, and
drains the whole fleet on exit (or SIGTERM). With ``--session-dir`` the
replicas share one durable session store, so conversations survive replica
drains and whole-fleet restarts, and a ``--session-id`` turn may be served by
a different replica each invocation. One stdout line a prompt, in
submission order, as the serving CLI prints them.

Every replica runs on the card (``--device cuda``, the default) unless
``--device cpu``; a child that finds no card fails at start-up and the fleet
does not serve. ``--local`` runs the replicas as threads of this process
over one model instead of child processes: the same router / supervisor
wiring without the spawn cost.

A turn that comes back ``suspended`` because its replica drained under it
(a SIGTERM to that child, a drain-and-respawn of a degraded replica) is
continued through the router from the shared session store, on another
replica, and its line holds the whole turn's tokens: bitwise the
uninterrupted turn's. (The reference CLI prints such a turn as
``[suspended]``.)

Refused by name, as the serving CLI refuses them: ``--tp`` (ROADMAP.md A12)
and ``--exec-dir`` (A13).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from orion_tpu_torch.fleet.replica import (LocalReplica, ProcessReplica, ReplicaSpec, build_model,
                                           serve_config)
from orion_tpu_torch.fleet.supervisor import Supervisor
from orion_tpu_torch.serving.__main__ import slo_objectives
from orion_tpu_torch.serving.server import OverloadError, RejectedError

# the reference's flags for what is not ported: (flag, type, default, item)
_NOT_PORTED_FLAGS = (
    ("--tp", int, 0, "A12 step 8"),
    ("--exec-dir", str, None, "A13"),
)
# how many times one turn is continued after drains under it
MAX_CONTINUATIONS = 4


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("orion_tpu_torch.fleet")
    p.add_argument("--config", default="tiny")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--replicas", type=int, default=2,
                   help="engine replicas behind the router (child serving processes; --local "
                        "makes them threads)")
    p.add_argument("--local", action="store_true",
                   help="thread-backed replicas in this process instead of child OS processes")
    p.add_argument("--device", default="cuda",
                   help="where every replica runs: cuda (default) or cpu")
    p.add_argument("--max-inflight", type=int, default=0,
                   help="FLEET-level admission bound across all replicas (0 = per-replica bounds "
                        "only); beyond it submits shed with OverloadError")
    p.add_argument("--session-dir", default=None,
                   help="SHARED durable-session store: any replica resumes any conversation from "
                        "disk (migration is a read)")
    p.add_argument("--session-id", default=None,
                   help="tag prompts as conversation turns (line i gets '<id>-<i>' when several "
                        "prompts are given)")
    p.add_argument("--prompts-file", default="-", help="one prompt per line; '-' = stdin")
    p.add_argument("--max-new-tokens", type=int, default=64)
    # pass-through engine knobs (per replica)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--prefill-chunk", type=int, default=64)
    p.add_argument("--prefill-buckets", default="pow2")
    p.add_argument("--replica-max-inflight", type=int, default=8,
                   help="per-replica admission queue bound")
    p.add_argument("--qmode", choices=["off", "int8", "int4"], default="off",
                   help="quantized serving inside EVERY replica (each quantizes the same weights "
                        "the same deterministic way, so placement stays invisible in the tokens)")
    p.add_argument("--spec-depth", type=int, default=0,
                   help="self-speculative decode inside every replica (tokens stay bitwise the "
                        "plain walk's; 0 = off)")
    p.add_argument("--spec-min-accept", type=float, default=0.2,
                   help="per-slot speculation floor inside each replica (0 = never)")
    p.add_argument("--prefix-dir", default=None,
                   help="SHARED content-addressed prefix cache: a prefix published by one replica "
                        "admits O(suffix) on every replica (needs --prefill-chunk > 0)")
    p.add_argument("--prefix-len", type=int, default=0,
                   help="declare the first N tokens of every prompt a shared cacheable prefix "
                        "(a miss publishes to --prefix-dir; 0 = never publish)")
    p.add_argument("--autoscale", type=int, default=0,
                   help="elastic fleet: let the supervisor move the replica count between 1 and "
                        "this many on capacity headroom / queue depth / SLO burn (0 = fixed "
                        "fleet); scale-in drains through the shared session store")
    p.add_argument("--pin-cores", action="store_true",
                   help="pin each replica process to one core (rotating by replica index), its "
                        "CPU thread pool sized to it")
    p.add_argument("--deadline-ms", type=float, default=0.0)
    p.add_argument("--metrics-port", type=int, default=-1,
                   help="serve the LIVE fleet-aggregated view on this port (0 = ephemeral, "
                        "printed on stderr; -1 = off): /metrics sums every replica's registry "
                        "from the supervisor's heartbeat snapshots (staleness <= --heartbeat-s), "
                        "/healthz is 200 while any replica is routable, /statusz is the "
                        "router's fleet snapshot, /slo the per-replica burn rates and budgets")
    p.add_argument("--slo-latency-ms", type=float, default=0.0,
                   help="declare a per-turn latency SLO on every replica (--slo-target of turns "
                        "under this many ms; below 10000): arms the control loop -- a fast burn "
                        "degrades and sheds on the replica, the router tie-breaks on windowed "
                        "p99, the supervisor drain-respawns a persistent burner")
    p.add_argument("--slo-target", type=float, default=0.99,
                   help="good-event fraction each declared objective promises")
    p.add_argument("--metrics-path", default=None,
                   help="fleet-aggregated Prometheus-text metrics dump (+ .json with the "
                        "per-replica breakdown), written on exit; each replica also dumps its "
                        "own registry at <path>.<replica> while serving")
    p.add_argument("--trace-path", default=None,
                   help="request trace: the router and every replica write Chrome trace-event "
                        "JSONL (<path>.<name>.jsonl), merged on exit into <path> (Perfetto)")
    p.add_argument("--flight-dir", default=None,
                   help="flight-recorder dump directory for the parent (router / supervisor) "
                        "AND every replica")
    p.add_argument("--no-cost", action="store_true",
                   help="disable per-request cost attribution and the capacity model inside "
                        "every replica (on by default: the fleet /metrics.json then carries an "
                        "aggregated capacity section)")
    p.add_argument("--profile-dir", default=None,
                   help="arm-able torch.profiler capture inside every replica (each writes to "
                        "<dir>/<replica>); off by default")
    p.add_argument("--heartbeat-s", type=float, default=1.0, help="supervisor heartbeat interval")
    p.add_argument("--grace", type=float, default=30.0)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="ModelConfig override (must match the checkpoint)")
    for flag, typ, default, item in _NOT_PORTED_FLAGS:
        p.add_argument(flag, type=typ, default=default,
                       help=f"not ported to orion_tpu_torch yet (ROADMAP.md {item})")
    return p


def check_flags(args) -> None:
    """Refuse every reference flag the port does not serve yet."""
    for flag, _, default, item in _NOT_PORTED_FLAGS:
        value = getattr(args, flag[2:].replace("-", "_"))
        if value != default and not (flag == "--tp" and value == 1):
            raise NotImplementedError(
                f"{flag} is not ported to orion_tpu_torch yet (ROADMAP.md queue A, {item})")


def _spec_from_args(args) -> ReplicaSpec:
    overrides = {}
    if args.set:
        from orion_tpu_torch.utils.config import parse_set_overrides

        overrides = parse_set_overrides(args.set)
    serve = {
        "slots": args.slots,
        "chunk": args.chunk,
        "prefill_chunk": args.prefill_chunk,
        "prefill_buckets": args.prefill_buckets,
        "max_inflight": args.replica_max_inflight,
        "deadline_ms": args.deadline_ms,
        "grace": args.grace,
        "session_dir": args.session_dir,
        "qmode": args.qmode,
        "spec_depth": args.spec_depth,
        "spec_min_accept": args.spec_min_accept,
        "prefix_dir": args.prefix_dir,
        # cost attribution and capacity inside every replica
        "cost": not args.no_cost,
        # params_id is NOT set here: every replica derives it from the
        # weights it actually loads (build_model: config + overrides +
        # resolved checkpoint step or init seed)
    }
    slo = slo_objectives(args.slo_latency_ms, args.slo_target)
    if slo:
        # declared objectives arm actuation inside every replica; the
        # supervisor and router act on the burn rates over the status op
        serve["slo"] = list(slo)
    return ReplicaSpec(config=args.config, overrides=overrides or None, ckpt_dir=args.ckpt_dir,
                       serve=serve, device=args.device)


def _obs_serve_overrides(args, name: str) -> dict:
    """Per-replica telemetry paths (ServeConfig kwargs): each replica gets its
    own metrics / trace file keyed by its name, aggregated or merged in the
    parent afterwards."""
    out = {}
    if args.metrics_path:
        out["metrics_path"] = f"{args.metrics_path}.{name}"
    if args.trace_path:
        out["trace_path"] = f"{args.trace_path}.{name}.jsonl"
    if args.flight_dir:
        out["flight_dir"] = args.flight_dir
    if args.profile_dir:
        import os as _os

        out["profile_dir"] = _os.path.join(args.profile_dir, name)
    return out


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    check_flags(args)
    if args.session_id and not args.session_dir:
        print("--session-id requires --session-dir", file=sys.stderr)
        return 2
    spec = _spec_from_args(args)

    # parent-side telemetry: the router's root spans and the supervisor /
    # control-channel black box (replicas configure their own)
    tracer = None
    if args.trace_path:
        import time as _time

        from orion_tpu_torch.obs.trace import Tracer

        # the replicas' Server clock: merged spans must share its epoch
        tracer = Tracer(path=f"{args.trace_path}.router.jsonl", clock=_time.monotonic)
    if args.flight_dir:
        from orion_tpu_torch.obs import flight

        flight.configure(dump_dir=args.flight_dir)

    def _spec_for(name: str) -> ReplicaSpec:
        obs = _obs_serve_overrides(args, name)
        if not obs:
            return spec
        return dataclasses.replace(spec, serve={**(spec.serve or {}), **obs})

    if args.local:
        model, params_id = build_model(spec)

        def factory(name: str):
            return LocalReplica(model, serve_config(_spec_for(name), params_id=params_id),
                                name=name).start()
    else:
        import os

        def factory(name: str):
            s = _spec_for(name)
            if args.pin_cores:
                idx = Supervisor.replica_index(name)
                s = dataclasses.replace(s, compute_cpus=[idx % (os.cpu_count() or 1)])
            return ProcessReplica(s, name=name).start()

    from orion_tpu_torch.generate import SampleConfig
    from orion_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    sample = SampleConfig(args.temperature, args.top_k, args.top_p)

    if args.prompts_file == "-":
        lines = [ln.rstrip("\n") for ln in sys.stdin]
    else:
        with open(args.prompts_file) as f:
            lines = [ln.rstrip("\n") for ln in f]
    if args.session_id:
        lines = lines or [""]
    else:
        lines = [ln for ln in lines if ln]

    autoscale = None
    if args.autoscale > 0:
        from orion_tpu_torch.fleet.supervisor import AutoscalePolicy

        # queue pressure keyed to the per-replica admission bound: the fleet
        # scales out when the average replica's queue is full
        autoscale = AutoscalePolicy(
            min_replicas=1, max_replicas=max(args.autoscale, args.replicas),
            queue_high=float(args.replica_max_inflight),
            queue_low=max(args.replica_max_inflight / 4.0, 1.0))
    sup = Supervisor(factory, args.replicas, max_inflight=args.max_inflight, tracer=tracer,
                     autoscale=autoscale).start()
    sup.start_monitor(interval=args.heartbeat_s)
    rc = 0
    completed = []
    aggregated = None
    http = None
    try:
        # inside the try: the replicas are spawned already, so a bind failure
        # must still reach the finally's drain_all
        http = _start_fleet_http(args, sup)
        import numpy as np

        from orion_tpu_torch.serving.session import DecodeRequest

        for i, line in enumerate(lines):
            sid = None
            if args.session_id:
                sid = args.session_id if len(lines) == 1 else f"{args.session_id}-{i}"
            req = DecodeRequest(prompt=np.asarray([tok.encode(line)], np.int64).reshape(1, -1),
                                max_new_tokens=args.max_new_tokens, sample=sample,
                                seed=args.seed + i, session_id=sid,
                                prefix_len=max(args.prefix_len, 0))
            pending = _submit(sup, req, completed)
            if pending is None:
                rc = 1
                break
            completed.append((line, pending, req))
        for line, pending, _ in completed:
            if pending.done.wait(timeout=600.0):
                continue
            print(f"[dropped] {line}", file=sys.stderr)
        results = [_continue_drained(sup, req, pending) for _, pending, req in completed]
        for (line, _, _), (result, error) in zip(completed, results):
            if error is not None:
                print(f"[{type(error).__name__}] {line}", file=sys.stderr)
                continue
            if result is None:
                continue
            ids = [int(t) for t in result.tokens[0]]
            tag = "" if result.status == "ok" else f" [{result.status}]"
            print(line + tok.decode(ids) + tag)
        snap = sup.router.snapshot()
        print(f"fleet: {snap}", file=sys.stderr)
        if args.metrics_path or not args.no_cost:
            # scrape while the replicas still answer status: after the drain
            # there is nobody to ask
            aggregated = sup.aggregate_metrics()
            cap = aggregated.get("capacity") or {}
            if not cap.get("no_data"):
                print(f"fleet capacity: ceiling {cap['ceiling_tokens_per_s']} tok/s, current "
                      f"{cap['current_tokens_per_s']} tok/s, headroom {cap['headroom']:.3f} over "
                      f"{cap['replicas_reporting']} replica(s)", file=sys.stderr)
    finally:
        sup.drain_all(timeout=args.grace * 2)
        if http is not None:
            http.close()
        _dump_fleet_obs(args, tracer, aggregated)
    return rc


def _submit(sup, req, completed):
    """Place one request, waiting out fleet-wide overload the way the
    serving CLI drains in waves (for the oldest outstanding result, then
    again); None when the fleet rejects it."""
    while True:
        try:
            return sup.router.submit(req)
        except OverloadError:
            for _, p, _ in completed:
                if not p.done.is_set():
                    p.done.wait(timeout=60.0)
                    break
        except RejectedError as e:
            print(f"rejected: {e}", file=sys.stderr)
            return None


def _continue_drained(sup, req, pending):
    """(result, error) of the turn ``req``. A session turn its replica
    suspended mid-stream by draining is continued from the shared store
    through the router (an empty-prompt turn for the tokens still owed), up
    to ``MAX_CONTINUATIONS`` times; the tokens are concatenated, bitwise one
    uninterrupted turn."""
    import numpy as np

    from orion_tpu_torch.serving.session import DecodeRequest

    if not pending.done.is_set():
        return None, None
    result, error = pending.result, pending.error
    sid, tokens = req.session_id, []
    for _ in range(MAX_CONTINUATIONS):
        if sid is None or error is not None or result is None or result.status != "suspended":
            break
        tokens.append(np.asarray(result.tokens))
        owed = req.max_new_tokens - sum(t.shape[1] for t in tokens)
        if owed <= 0:
            break
        cont = DecodeRequest(prompt=np.zeros((1, 0), np.int64), max_new_tokens=owed,
                             sample=req.sample, session_id=sid)
        nxt = _submit(sup, cont, [])
        if nxt is None or not nxt.done.wait(timeout=600.0):
            return None, RejectedError(f"the continuation of {sid!r} was not served")
        print(f"[fleet] {sid}: continued after a drain, {owed} token(s) on "
              f"{getattr(nxt, 'replica', '') or 'a local replica'}", file=sys.stderr)
        result, error = nxt.result, nxt.error
    if tokens and result is not None and error is None and result.status != "suspended":
        result = dataclasses.replace(result, tokens=np.concatenate([*tokens, result.tokens], 1),
                                     new_tokens=sum(t.shape[1] for t in tokens) + result.new_tokens)
    return result, error


def _fleet_healthz(sup) -> dict:
    """Fleet-level /healthz: 200 while ANY replica is routable (the router can
    place work), 503 otherwise; the body carries the per-replica rows."""
    snap = sup.router.snapshot()
    routable = [r for r in snap["replicas"]
                if r["alive"] and r["state"] in ("starting", "serving", "degraded")]
    snap["code"] = 200 if routable else 503
    snap["accepting"] = bool(routable)
    return snap


def _fleet_metrics(sup) -> dict:
    """Fleet-level /metrics: aggregated over the supervisor-refreshed
    ``last_status`` snapshots (every heartbeat stores one a replica), never a
    status RPC a scrape; staleness is bounded by the heartbeat interval."""
    from orion_tpu_torch.obs.cost import fleet_capacity
    from orion_tpu_torch.obs.metrics import aggregate

    snaps, names = [], []
    for replica in list(sup.replicas):
        status = getattr(replica, "last_status", None)
        m = (status or {}).get("metrics")
        if m is not None:
            snaps.append(m)
            names.append(replica.name)
    agg = aggregate(snaps, sources=names)
    agg["replicas"] = len(names)
    # headroom recomputed from the summed ceiling / current gauges (the
    # summed headroom gauge is meaningless)
    agg["capacity"] = fleet_capacity(agg)
    return agg


def _fleet_slo(sup) -> dict:
    """Fleet-level /slo: every replica's burn rates and budgets from its last
    heartbeat snapshot."""
    out = {}
    for replica in list(sup.replicas):
        status = getattr(replica, "last_status", None)
        if status and status.get("slo"):
            out[replica.name] = status["slo"]
    return {"replicas": out}


def _start_fleet_http(args, sup):
    """The aggregated live endpoint (--metrics-port)."""
    if args.metrics_port is None or args.metrics_port < 0:
        return None
    from orion_tpu_torch.obs.http import ObsHTTPServer

    http = ObsHTTPServer(port=args.metrics_port, metrics_fn=lambda: _fleet_metrics(sup),
                         health_fn=lambda: _fleet_healthz(sup), statusz_fn=sup.router.snapshot,
                         slo_fn=lambda: _fleet_slo(sup))
    port = http.start()
    print(f"fleet telemetry: http://127.0.0.1:{port}/metrics | /healthz | /statusz | /slo "
          "(aggregated over the status op)", file=sys.stderr)
    return http


def _dump_fleet_obs(args, tracer, aggregated) -> None:
    """Post-drain exposition: the fleet-aggregated metrics (Prometheus text +
    JSON with the per-replica breakdown) and the merged trace (router root
    spans + every replica's spans in one file)."""
    import glob
    import json as _json
    import os

    if aggregated is not None and args.metrics_path:
        from orion_tpu_torch.obs.metrics import prometheus_from_snapshot

        with open(args.metrics_path + ".tmp", "w") as f:
            f.write(prometheus_from_snapshot(aggregated))
        os.replace(args.metrics_path + ".tmp", args.metrics_path)
        with open(args.metrics_path + ".json.tmp", "w") as f:
            _json.dump(aggregated, f, indent=1, default=repr)
        os.replace(args.metrics_path + ".json.tmp", args.metrics_path + ".json")
        print(f"fleet metrics: {args.metrics_path} (+ .json)", file=sys.stderr)
    if tracer is not None and args.trace_path:
        from orion_tpu_torch.obs.trace import merge_traces

        tracer.flush()
        parts = sorted(glob.glob(args.trace_path + ".*.jsonl"))
        n = merge_traces(parts, args.trace_path)
        print(f"fleet trace: {n} events merged into {args.trace_path} from {len(parts)} "
              "file(s); load it in Perfetto", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
