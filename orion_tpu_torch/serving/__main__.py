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

The reference's flags for parts the port does not serve yet are accepted
and refused with ``NotImplementedError`` naming their ROADMAP.md item when
set: ``--spec-depth``,
``--spec-min-accept`` (A8 step 4), ``--tp`` (A12), ``--metrics-port``,
``--slo-latency-ms``, ``--slo-target``, ``--profile-dir`` (A9). The port
computes no cost attribution (A9), so the reference's ``--no-cost`` and
``--no-cost-ledger`` have nothing to turn off and are not flags here.
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
    ("--spec-depth", int, 0, "A8 step 4"),
    ("--spec-min-accept", float, 0.2, "A8 step 4"),
    ("--tp", int, 0, "A12"),
    ("--metrics-port", int, -1, "A9"),
    ("--slo-latency-ms", float, 0.0, "A9"),
    ("--slo-target", float, 0.99, "A9"),
    ("--profile-dir", str, None, "A9"),
)


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
    server = Server(model, ServeConfig(
        chunk=args.chunk, slots=args.slots, max_inflight=args.max_inflight,
        deadline_ms=args.deadline_ms, stall_timeout=args.stall_timeout, grace=args.grace,
        prefill_buckets=args.prefill_buckets, prefill_chunk=args.prefill_chunk,
        prompt_overflow=args.prompt_overflow, qmode=args.qmode,
        session_dir=args.session_dir, session_idle_s=args.session_idle_s,
        max_dirty_sessions=args.max_dirty_sessions, breaker_failures=args.breaker_failures,
        breaker_backoff=args.breaker_backoff, breaker_max_backoff=args.breaker_max_backoff,
        prefix_dir=args.prefix_dir, params_id=params_id,
        metrics_path=args.metrics_path, metrics_interval_s=args.metrics_interval_s,
        trace_path=args.trace_path, flight_dir=args.flight_dir))
    del model
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
          + ")", file=sys.stderr)
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
