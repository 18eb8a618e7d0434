"""``python -m orion_tpu_torch.serving`` -- batch serving through the
bounded-admission ``Server`` (the port's counterpart of
``orion_tpu/serving/__main__.py``).

Reads prompts (one per line, ``--prompts-file`` or stdin), submits them
through the bounded admission queue, and drains in waves: when the queue
fills, the loop serves until idle and resumes submitting, so a prompt file
larger than ``--max-inflight`` still completes while overload shedding stays
observable (``--no-wave`` sheds instead). SIGTERM at any point drains
gracefully: in-flight requests finish, the rest are rejected, exit code 0.
One stdout line per prompt, in submission order; ``stats:`` and ``slot
occupancy:`` on stderr.

Runs on the card (``--device cuda``, the default) unless ``--device cpu``.
Without ``--ckpt-dir`` the weights are the seeded init (a ``Generator``
seeded 0, as ``generate``'s CLI); bf16 configs are rounded to their compute
dtype once (``cast_params_for_inference``) unless ``--qmode`` quantizes.

Durable sessions: ``--session-dir`` with ``--session-id`` tags the prompts as
turns of one conversation (line i as ``<id>-<i>`` when there are several);
an empty line (or no input at all) is a continuation turn that resumes the
saved session. The prefix cache: ``--prefix-dir``, and ``--prefix-len N``
declares every prompt's first N tokens a shared prefix. The stores key on a
weights identity derived as the JAX package's CLI does: ``--config``, the
fingerprint of the ``--set`` overrides, and the checkpoint's step (or the
init seed 0).

Self-speculative decode: ``--spec-depth N`` drafts N tokens a slot a round
on the model's linear layers and verifies them in one piece (the tokens are
the plain walk's, bitwise), ``--spec-min-accept`` floors a slot whose rolling
acceptance falls below it; a ``speculation:`` line on stderr counts the
drafts accepted and rejected and the floors.

Telemetry: ``--metrics-port`` serves ``/metrics``, ``/healthz``,
``/statusz``, ``/slo``, ``/costz`` and ``/profilez?chunks=K`` live (0 = an
ephemeral port, printed on stderr); ``--slo-latency-ms`` declares a per-turn
latency objective (with error-rate and availability ones at
``--slo-target``), which arms the SLO actuation; cost attribution is on
unless ``--no-cost`` (a ``cost:`` line on stderr); ``--profile-dir`` lets
``/profilez`` record the next K boundaries with ``torch.profiler``.

The reference's ``--tp`` is accepted and refused with ``NotImplementedError``
naming its ROADMAP.md item (A12) when set. ``--no-cost-ledger`` is accepted:
the port has no ledger harvest to skip until A13.
"""

from __future__ import annotations

import argparse
import sys

import torch

from orion_tpu_torch.generate import SampleConfig, cast_params_for_inference, load_model
from orion_tpu_torch.models.configs import get_config
from orion_tpu_torch.models.transformer import TransformerLM
from orion_tpu_torch.resilience.preempt import PreemptionGuard
from orion_tpu_torch.resilience.retry import RetryPolicy
from orion_tpu_torch.serving.health import Health
from orion_tpu_torch.serving.prefix_store import overrides_fingerprint
from orion_tpu_torch.serving.server import (OverloadError, RejectedError, ServeConfig, Server,
                                            load_tokenizer)
from orion_tpu_torch.serving.session import DecodeRequest
from orion_tpu_torch.utils.device import resolve_device

# the reference's flags for what is not ported: (flag, type, default, item)
_NOT_PORTED_FLAGS = (
    ("--tp", int, 0, "A12 step 8"),
)


def slo_objectives(latency_ms: float, target: float):
    """The objectives ``--slo-latency-ms`` declares (JSON-able Objective
    kwargs): per-turn latency, error rate and availability at ``target``;
    None for 0 (the observe-only defaults). The SLOEngine refuses a latency
    at or above the histogram's last finite bucket (10000 ms): turns past it
    are unresolvable and would all score bad."""
    if latency_ms <= 0:
        return None
    return ({"name": "turn_latency", "kind": "latency", "latency_ms": latency_ms,
             "target": target},
            {"name": "error_rate", "kind": "error_rate", "target": target},
            {"name": "availability", "kind": "availability", "target": target})


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("orion_tpu_torch.serving")
    p.add_argument("--config", default="tiny")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory (orion_tpu_torch.train or export_jax_checkpoint.py); "
                        "default: seeded random params")
    p.add_argument("--prompts-file", default="-", help="one prompt per line; '-' = stdin")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--chunk", type=int, default=16,
                   help="decode chunk length: the deadline / drain / admission granularity")
    p.add_argument("--slots", type=int, default=8,
                   help="concurrent decode slots sharing one batched carry (at most 64)")
    p.add_argument("--prefill-buckets", default="pow2",
                   help="prompt-length buckets for prefill padding: 'pow2' (default), a comma "
                        "list like '32,64,128', or 'off' (host prefill only: --prefill-chunk 0)")
    p.add_argument("--prefill-chunk", type=int, default=64,
                   help="in-scan chunked prefill: prompt tokens consumed per chunk boundary "
                        "inside the batched program; 0 = host prefill at admission")
    p.add_argument("--prompt-overflow", choices=["error", "clamp"], default="error",
                   help="prompts longer than the largest bucket: refuse (error) or serve the "
                        "newest bucket-sized context (clamp)")
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="per-request deadline, enforced at chunk boundaries (0 = none)")
    p.add_argument("--max-inflight", type=int, default=8,
                   help="admission bound; a full queue sheds (OverloadError)")
    p.add_argument("--stall-timeout", type=float, default=0.0,
                   help="watchdog heartbeat budget per decode chunk (0 = off); must exceed the "
                        "kernels' build + one chunk")
    p.add_argument("--spec-depth", type=int, default=0,
                   help="self-speculative decode: the model's own linear layers draft up to "
                        "this many tokens a slot and the full model verifies them in one "
                        "piece; the tokens stay bitwise the plain walk's, greedy and sampled, "
                        "only the speed changes; 0 = off (a config with a linear layer, no "
                        "MoE, spec-depth + 1 <= window with swa layers)")
    p.add_argument("--spec-min-accept", type=float, default=0.2,
                   help="speculation floor: a slot whose rolling draft acceptance drops below "
                        "this rides plain decode for the rest of its residency (0 = never)")
    p.add_argument("--qmode", choices=["off", "int8", "int4"], default="off",
                   help="quantize the weights once at startup (orion_tpu_torch/quant.py)")
    p.add_argument("--prefix-dir", default=None,
                   help="content-addressed prefix cache root: a shared prompt prefix is one "
                        "O(1) decode-state snapshot, so a hit admits at O(suffix); replicas "
                        "sharing the directory share the cache. Needs --prefill-chunk > 0")
    p.add_argument("--prefix-len", type=int, default=0,
                   help="declare every prompt's first N tokens a shared prefix: a miss "
                        "publishes its chunk-aligned snapshot (0 = never publish)")
    p.add_argument("--session-dir", default=None,
                   help="durable-session store root: conversations suspend to one snapshot at "
                        "a turn's end (and on a SIGTERM drain) and resume bitwise across "
                        "restarts")
    p.add_argument("--session-id", default=None,
                   help="tag the prompts as turns of this conversation (line i as '<id>-<i>' "
                        "when there are several); an EMPTY line (or no input) resumes the "
                        "saved session and continues generating")
    p.add_argument("--session-idle-s", type=float, default=300.0,
                   help="idle eviction of the resident session cache at chunk boundaries (the "
                        "state stays on disk; 0 = off)")
    p.add_argument("--max-dirty-sessions", type=int, default=32,
                   help="write-behind bound in a session-store outage: past this many DIRTY "
                        "sessions, new session turns shed with a retriable overload error "
                        "(0 = no bound)")
    p.add_argument("--breaker-failures", type=int, default=3,
                   help="failed store operations in a row that OPEN a store's circuit "
                        "breaker: every store touch then fails in O(1) host work, health reads "
                        "DEGRADED 'store-outage:<store>' and requests keep serving")
    p.add_argument("--breaker-backoff", type=float, default=0.5,
                   help="open-breaker dwell (seconds) before the first half-open probe; "
                        "doubles per re-trip up to --breaker-max-backoff, jittered")
    p.add_argument("--breaker-max-backoff", type=float, default=30.0,
                   help="probe backoff ceiling (seconds)")
    p.add_argument("--grace", type=float, default=30.0, help="SIGTERM drain budget (seconds)")
    p.add_argument("--metrics-path", default=None,
                   help="Prometheus-text metrics file (+ a .json sibling), rewritten atomically "
                        "every --metrics-interval-s at chunk boundaries and on drain")
    p.add_argument("--metrics-interval-s", type=float, default=10.0,
                   help="periodic metrics dump cadence (<= 0: on drain only)")
    p.add_argument("--trace-path", default=None,
                   help="request-trace JSONL (Chrome trace events); merge with `python -m "
                        "orion_tpu_torch.obs.trace merge` and load in Perfetto")
    p.add_argument("--flight-dir", default=None,
                   help="flight-recorder dump directory (DEGRADED / DRAINING / DEAD, ladder "
                        "exhaustion, watchdog stalls)")
    p.add_argument("--metrics-port", type=int, default=-1,
                   help="serve LIVE /metrics (Prometheus text), /healthz (its status code tracks "
                        "the health state), /statusz, /slo, /costz and /profilez?chunks=K on "
                        "this port from a daemon thread (0 = ephemeral, printed on stderr; -1 = "
                        "off); every scrape reads host state only")
    p.add_argument("--slo-latency-ms", type=float, default=0.0,
                   help="declare a per-turn latency SLO: --slo-target of turns under this many "
                        "ms (plus error-rate and availability objectives at --slo-target); arms "
                        "actuation: a lasting fast burn degrades health and sheds admissions "
                        "earlier. Below 10000 (the latency histogram's last finite bucket). 0 = "
                        "observe-only defaults")
    p.add_argument("--slo-target", type=float, default=0.99,
                   help="good-event fraction each declared objective promises (error budget = "
                        "1 - target)")
    p.add_argument("--no-cost", action="store_true",
                   help="disable per-request cost attribution and the capacity model (on by "
                        "default: every result carries its device_ms / flops share, /costz and "
                        "/statusz report the tokens/s ceiling and headroom; host arithmetic at "
                        "boundaries)")
    p.add_argument("--no-cost-ledger", action="store_true",
                   help="accepted for the reference's command lines; the port has no ledger "
                        "harvest (compiled programs' flops and bytes) until ROADMAP.md A13, so "
                        "there is nothing to skip: attribution weighs by token counts and flops "
                        "are the analytic 2 x params")
    p.add_argument("--profile-dir", default=None,
                   help="arm-able on-demand torch.profiler capture: GET /profilez?chunks=K (or "
                        "Server.arm_profile) records the next K boundaries into a Chrome trace "
                        "under this directory; off by default")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tokenizer", default=None, help="BPE tokenizer JSON; default byte-level")
    p.add_argument("--eos", action="store_true", help="stop sequences at the tokenizer's <eos>")
    p.add_argument("--ckpt-attempts", type=int, default=4)
    p.add_argument("--no-wave", action="store_true",
                   help="don't drain-and-resume on overload: shed excess prompts (on stderr)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="ModelConfig override (must match the checkpoint)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
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


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    check_flags(args)
    # ONE guard spans the whole lifecycle (startup, submission, every serve
    # wave), so SIGTERM during model load or between waves drains (exit 0)
    # too; Server.serve polls this guard instead of installing its own
    with PreemptionGuard(grace=args.grace) as guard:
        return _run(args, guard)


def _run(args, guard) -> int:
    retry = RetryPolicy(attempts=max(args.ckpt_attempts, 1))
    cfg = get_config(args.config)
    overrides = {}
    if args.set:
        from orion_tpu_torch.utils.config import apply_overrides, parse_set_overrides

        overrides = parse_set_overrides(args.set)
        cfg = apply_overrides(cfg, overrides)
    # the weights' identity the stores key on, as the JAX package's CLI
    # derives it: config, overrides, checkpoint step or init seed
    ov = overrides_fingerprint(overrides)
    tok = load_tokenizer(args.tokenizer, retry=retry)
    eos_token = tok.eos if args.tokenizer and args.eos else -1
    device = resolve_device(args.device)
    if args.ckpt_dir:
        model, step = load_model(cfg, args.ckpt_dir, device, attempts=args.ckpt_attempts)
        cfg = model.cfg
        print(f"serving step {step} from {args.ckpt_dir}", file=sys.stderr)
        params_id = f"{args.config}:ov={ov}:ckpt={args.ckpt_dir}:step={step}"
    else:
        model = TransformerLM(cfg, device=device,
                              generator=torch.Generator(device=device).manual_seed(0))
        print("no --ckpt-dir: random params (smoke test)", file=sys.stderr)
        params_id = f"{args.config}:ov={ov}:seed=0"
    if args.tokenizer and tok.vocab_size > cfg.vocab_size:
        # out-of-vocab ids would be served as garbage with status 'ok'
        raise ValueError(f"tokenizer vocab {tok.vocab_size} > model vocab {cfg.vocab_size}")
    if args.qmode == "off":
        model = cast_params_for_inference(model)

    if args.prompts_file == "-":
        lines = [ln.rstrip("\n") for ln in sys.stdin]
    else:
        with open(args.prompts_file) as f:
            lines = [ln.rstrip("\n") for ln in f]
    if args.session_id:
        lines = lines or [""]  # an empty line is a continuation turn
    else:
        lines = [ln for ln in lines if ln]
    if args.session_id and not args.session_dir:
        print("--session-id requires --session-dir", file=sys.stderr)
        return 2

    sample = SampleConfig(args.temperature, args.top_k, args.top_p, eos_token=eos_token)
    slo_cfg = slo_objectives(args.slo_latency_ms, args.slo_target)
    server = Server(model, ServeConfig(
        chunk=args.chunk, slots=args.slots, max_inflight=args.max_inflight,
        deadline_ms=args.deadline_ms, stall_timeout=args.stall_timeout, grace=args.grace,
        prefill_buckets=args.prefill_buckets, prefill_chunk=args.prefill_chunk,
        prompt_overflow=args.prompt_overflow, qmode=args.qmode, spec_depth=args.spec_depth,
        spec_min_accept=args.spec_min_accept,
        session_dir=args.session_dir, session_idle_s=args.session_idle_s,
        max_dirty_sessions=args.max_dirty_sessions, breaker_failures=args.breaker_failures,
        breaker_backoff=args.breaker_backoff, breaker_max_backoff=args.breaker_max_backoff,
        prefix_dir=args.prefix_dir, params_id=params_id,
        metrics_path=args.metrics_path, metrics_interval_s=args.metrics_interval_s,
        trace_path=args.trace_path, flight_dir=args.flight_dir, metrics_port=args.metrics_port,
        slo=slo_cfg, cost=not args.no_cost, profile_dir=args.profile_dir))
    del model
    if server.http_port is not None:
        print(f"live telemetry: http://127.0.0.1:{server.http_port}/metrics | /healthz | "
              "/statusz | /slo | /costz | /profilez?chunks=K", file=sys.stderr)
    if server.session_store is not None:
        known = server.session_store.list_sessions()
        if known:
            print(f"session store: {len(known)} suspended session(s) restorable from "
                  f"{args.session_dir}", file=sys.stderr)
    completed = []  # (prompt, Pending) in submission order
    rc = 0
    for i, line in enumerate(lines):
        if guard.should_stop:
            print(f"draining on signal: {len(lines) - i} prompt(s) not submitted",
                  file=sys.stderr)
            break
        sid = None
        if args.session_id:
            sid = args.session_id if len(lines) == 1 else f"{args.session_id}-{i}"
        req = DecodeRequest(prompt=[tok.encode(line)], max_new_tokens=args.max_new_tokens,
                            sample=sample, seed=args.seed + i, session_id=sid,
                            prefix_len=max(args.prefix_len, 0))
        try:
            completed.append((line, server.submit(req)))
        except OverloadError:
            if args.no_wave:
                print(f"shed (overload): {line!r}", file=sys.stderr)
                continue
            rc = server.serve(drain_when_idle=True, guard=guard)
            if server.health.state is Health.DEAD:
                # drained on a signal mid-wave: this prompt and the rest were
                # never submitted; an exit-0 run must not hide that
                print(f"draining on signal: {len(lines) - i} prompt(s) not submitted",
                      file=sys.stderr)
                break
            completed.append((line, server.submit(req)))
        except RejectedError:
            print(f"rejected ({server.health.state.value}): {line!r}", file=sys.stderr)
            break
        if server.health.state is Health.DEAD:
            break
    if server.health.state is not Health.DEAD:
        rc = server.serve(drain_when_idle=True, guard=guard)
        server.close()

    for line, pending in completed:
        r = pending.result
        if r is None:
            why = type(pending.error).__name__ if pending.error else "dropped"
            print(f"[{why}] {line}", file=sys.stderr)
            continue
        ids = [int(t) for t in r.tokens[0]]
        if eos_token >= 0 and eos_token in ids:
            ids = ids[: ids.index(eos_token)]
        tag = "" if r.status == "ok" else f" [{r.status}]"
        print(line + tok.decode(ids) + tag)
    print(f"stats: {server.stats}", file=sys.stderr)
    mode = (f"in-scan prefill, {server.engine.prefill_chunk} tok/boundary"
            if args.prefill_chunk else "host prefill")
    print(f"slot occupancy: {server.occupancy_lifetime():.3f} ({args.slots} slot(s), chunk "
          f"{args.chunk}, {mode}" + (f", qmode {args.qmode}" if args.qmode != "off" else "")
          + (f", spec-depth {args.spec_depth}" if args.spec_depth else "") + ")", file=sys.stderr)
    if args.spec_depth:
        flat = server.metrics.counters_flat()
        acc, rej = flat.get("spec_accepted_total", 0), flat.get("spec_rejected_total", 0)
        rate = acc / (acc + rej) if acc + rej else 0.0
        print(f"speculation: {acc} draft(s) accepted, {rej} rejected (rate {rate:.3f}), "
              f"{flat.get('spec_floor_total', 0)} slot floor(s)", file=sys.stderr)
    if not args.no_cost:
        flat = server.metrics.counters_flat()
        cap = server.capacity.state() if server.capacity else {}
        line = (f"cost: {flat.get('attributed_ms_total', 0):.1f} ms device time attributed over "
                f"{flat.get('decode_tokens_total', 0)} decode + "
                f"{flat.get('prefill_tokens_total', 0)} prefill token(s)")
        if not cap.get("no_data"):
            line += (f"; capacity ceiling {cap['ceiling_tokens_per_s']} tok/s, headroom "
                     f"{cap['headroom']:.3f}")
        print(line, file=sys.stderr)
    if args.prefix_dir:
        flat = server.metrics.counters_flat()
        print(f"prefix cache: {flat.get('prefix_hits', 0)} hit(s), "
              f"{flat.get('prefix_misses', 0)} miss(es), {flat.get('prefix_publishes', 0)} "
              "publish(es)", file=sys.stderr)
    if args.metrics_path:
        print(f"metrics: {args.metrics_path} (+ .json)", file=sys.stderr)
    if args.trace_path:
        print(f"trace: {args.trace_path} -- merge for Perfetto with `python -m "
              f"orion_tpu_torch.obs.trace merge {args.trace_path} -o trace.json`",
              file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
