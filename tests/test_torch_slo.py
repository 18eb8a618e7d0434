"""The port's SLO engine and live endpoints (``orion_tpu_torch/obs/slo.py``,
``obs/http.py`` and their wiring in ``serving/server.py``) against the JAX
package's on the CPU.

- ``quantile_from_counts`` at the empty and single-sample edges and on
  numpy-drawn histograms: equal to the JAX package's, exactly;
- ``SLOEngine.state()`` key by key equal to the JAX package's for the same
  metric feed (counters and latencies drawn with numpy) on the same injected
  clock, for the observe-only defaults, declared turn objectives and a
  chunk-source objective; a latency at the histogram's last finite bucket
  refused by both;
- ``check_snapshot`` and ``python -m ... obs.slo check`` on the same dumped
  snapshot: the same rows, verdict and exit code;
- ``/healthz``: the status code of every health state equal to the JAX
  Server's endpoint's; the ``/slo`` and ``/costz`` payloads carry the JAX
  Server's keys after the same requests; the SLO actuation inside the port
  (a sustained fast burn degrades health and sheds at half the bound; the
  ``--slo-latency-ms`` refusal at 10000 ms).

Tolerance: exact equality (the modules are copies; the same inputs give the
same floats).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.obs import slo as jax_slo
from orion_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from orion_tpu.serving import DecodeRequest as JaxDecodeRequest
from orion_tpu.serving import ServeConfig as JaxServeConfig
from orion_tpu.serving import Server as JaxServer
from orion_tpu.serving.health import Health as JaxHealth
from orion_tpu_torch.obs import slo
from orion_tpu_torch.obs.metrics import MetricsRegistry
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.serving import (DecodeRequest, Health, OverloadError, ServeConfig, Server)
from orion_tpu_torch.serving.__main__ import main as cli_main
from torch_serving_common import CFG, GREEDY, jax_model, jax_params, jax_sample, torch_model

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _get(url, timeout=10.0):
    try:
        r = urllib.request.urlopen(url, timeout=timeout)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- quantiles ----------------------------------------------------------------------------


_Q_CASES = {
    "empty": ((1, 10, 100, float("inf")), (0, 0, 0, 0)),
    "single": ((1, 10, 100, float("inf")), (0, 1, 0, 0)),
    "overflow": ((1, 10, 100, float("inf")), (0, 0, 2, 5)),
    "drawn": (tuple(float(b) for b in (1, 2, 5, 10, 20, 50, 100, 200, 500)) + (float("inf"),),
              tuple(int(c) for c in np.random.default_rng(3).integers(0, 40, 10))),
}


@pytest.mark.parametrize("case", sorted(_Q_CASES))
def test_quantile_from_counts_matches_the_jax_package(case):
    buckets, counts = _Q_CASES[case]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert (slo.quantile_from_counts(buckets, counts, q)
                == jax_slo.quantile_from_counts(buckets, counts, q)), (case, q)
    if case == "empty":
        assert slo.quantile_from_counts(buckets, counts, 0.5) is None
    if case == "single":  # one sample: every quantile inside its bucket
        assert 1.0 <= slo.quantile_from_counts(buckets, counts, 0.99) <= 10.0


# -- the engine ---------------------------------------------------------------------------


_OBJECTIVES = {
    "defaults": None,
    "declared": [{"name": "turn_latency", "kind": "latency", "latency_ms": 200.0, "target": 0.9,
                  "fast_window_s": 1.0, "slow_window_s": 4.0},
                 {"name": "errs", "kind": "error_rate", "target": 0.95, "fast_window_s": 1.0,
                  "slow_window_s": 4.0, "fast_burn": 3.0, "slow_burn": 1.5},
                 {"name": "avail", "kind": "availability", "target": 0.9}],
    "chunk": [{"name": "chunk_p", "kind": "latency", "source": "chunk", "latency_ms": 50.0,
               "target": 0.8, "fast_window_s": 0.5, "slow_window_s": 2.0, "fast_burn": 3.0}],
}


def _engine(pkg, registry_cls, objectives, now):
    reg = registry_cls(clock=lambda: now[0])
    objs = ([pkg.Objective(**o) for o in objectives] if objectives
            else pkg.default_objectives())
    return reg, pkg.SLOEngine(objs, pkg.registry_readers(reg), clock=lambda: now[0],
                              slice_s=0.25)


@pytest.mark.parametrize("objectives", sorted(_OBJECTIVES))
def test_slo_engine_state_matches_the_jax_package(objectives):
    """The same feed (a clean phase, a bad phase, a recovery) into both
    engines on one clock: ``state()`` equal key by key after every tick, and
    the walk fires and clears alerts."""
    now = [0.0]
    port_reg, port = _engine(slo, MetricsRegistry, _OBJECTIVES[objectives], now)
    jax_reg, ref = _engine(jax_slo, JaxRegistry, _OBJECTIVES[objectives], now)
    rng = np.random.default_rng(11)
    fired = False
    for tick in range(48):
        now[0] += 0.25
        bad = 16 <= tick < 28
        incs = {"ok": int(rng.integers(2, 8)), "admitted": int(rng.integers(2, 8)),
                "failed": int(rng.integers(0, 6)) if bad else 0,
                "deadline": int(rng.integers(0, 2)) if bad else 0,
                "shed": int(rng.integers(0, 4)) if bad else 0, "rejected": 0}
        lat = rng.lognormal(6.5 if bad else 3.0, 0.5, 6)
        chunk = rng.lognormal(4.5 if bad else 2.5, 0.4, 3)
        for reg in (port_reg, jax_reg):
            for name, n in incs.items():
                reg.counter(name).inc(n)
            for v in lat:
                reg.histogram("turn_latency_ms").observe(float(v))
            for v in chunk:
                reg.histogram("chunk_ms").observe(float(v))
        got, want = port.tick(), ref.tick()
        assert got == want, f"tick {tick}"
        assert port.state() == ref.state()
        fired |= bool(got["firing_fast"])
    assert fired, "the bad phase must fire a fast-burn alert"
    assert port.tick()["firing_fast"] == []


def test_latency_at_the_last_finite_bucket_is_refused_by_both():
    for pkg, reg in ((slo, MetricsRegistry()), (jax_slo, JaxRegistry())):
        with pytest.raises(ValueError, match="last finite bucket"):
            pkg.SLOEngine([pkg.Objective(name="t", kind="latency", latency_ms=10000.0)],
                          pkg.registry_readers(reg))
    with pytest.raises(ValueError, match="last finite bucket"):
        cli_main(["--config", "tiny", "--device", "cpu", "--slo-latency-ms", "10000",
                  "--prompts-file", "/dev/null"])


# -- the check gate ------------------------------------------------------------------------


def _dump(tmp_path, name, ok_n, failed_n, lat_ms, chunk_cells=()):
    reg = MetricsRegistry()
    reg.counter("ok").inc(ok_n)
    reg.counter("failed").inc(failed_n)
    h = reg.histogram("turn_latency_ms")
    for v in np.random.default_rng(ok_n).normal(lat_ms, lat_ms / 10, ok_n + failed_n):
        h.observe(float(abs(v)))
    c = reg.histogram("chunk_ms", buckets=(1, 2, 5, 10))
    for labels, value, n in chunk_cells:
        for _ in range(n):
            c.observe(value, labels=labels)
    path = str(tmp_path / f"{name}.prom")
    reg.dump(path)
    return path + ".json"


_CHECKS = {
    "ok": dict(ok_n=99, failed_n=0, lat_ms=8.0),
    "violated": dict(ok_n=8, failed_n=2, lat_ms=5000.0),
    "no_data": dict(ok_n=0, failed_n=0, lat_ms=1.0),
    "chunk_cells": dict(ok_n=9, failed_n=0, lat_ms=5.0,
                        chunk_cells=(({"tp": "1"}, 1.5, 8), ({"tp": "2"}, 8.0, 8))),
}


@pytest.mark.parametrize("case", sorted(_CHECKS))
def test_slo_check_matches_the_jax_package(tmp_path, capsys, case):
    objectives = [{"name": "turn_p99", "kind": "latency", "latency_ms": 100.0, "target": 0.9},
                  {"name": "errs", "kind": "error_rate", "target": 0.9},
                  {"name": "chunk_p", "kind": "latency", "latency_ms": 4.0, "source": "chunk",
                   "target": 0.6}]
    obj_path = tmp_path / "objectives.json"
    obj_path.write_text(json.dumps(objectives))
    snap = _dump(tmp_path, case, **_CHECKS[case])
    doc = json.loads(open(snap).read())
    rows, ok = slo.check_snapshot(slo.load_objectives(str(obj_path)), doc)
    assert (rows, ok) == jax_slo.check_snapshot(jax_slo.load_objectives(str(obj_path)), doc)
    for fmt in ("json", "text"):
        argv = ["check", "--objectives", str(obj_path), snap, "--format", fmt]
        rc = slo.main(argv)
        got = capsys.readouterr().out
        assert (rc, got) == (jax_slo.main(argv), capsys.readouterr().out)
    assert rc == (0 if case in ("ok", "no_data") else 1)


# -- the live endpoints --------------------------------------------------------------------


def _walk(health, state, enum):
    path = {"starting": [], "serving": ["serving"], "degraded": ["serving", "degraded"],
            "draining": ["serving", "draining"], "dead": ["serving", "draining", "dead"]}
    for s in path[state]:
        health.to(enum(s), "walk")


@pytest.mark.parametrize("state", ["starting", "serving", "degraded", "draining", "dead"])
def test_healthz_code_matches_the_jax_server(model, state):
    """The same health state on both Servers' live endpoints: the same
    status code, the same body keys, and the state and status fields."""
    srv = Server(model, ServeConfig(chunk=4, slots=2, metrics_port=0))
    jsrv = JaxServer(jax_model(), jax_params(), JaxServeConfig(chunk=4, slots=2, metrics_port=0,
                                                               mesh_audit=False))
    try:
        _walk(srv.health, state, Health)
        _walk(jsrv.health, state, JaxHealth)
        got = _get(f"http://127.0.0.1:{srv.http_port}/healthz")
        want = _get(f"http://127.0.0.1:{jsrv.http_port}/healthz")
        assert got[0] == want[0] == (200 if state in ("serving", "degraded") else 503)
        g, w = json.loads(got[1]), json.loads(want[1])
        assert set(g) == set(w) and (g["state"], g["status"]) == (w["state"], w["status"])
    finally:
        srv.close()
        jsrv.close()


def _keys(doc, depth=2):
    """The key paths of a JSON document down to ``depth``."""
    out = set()
    if isinstance(doc, dict) and depth:
        for k, v in doc.items():
            out.add(k)
            out |= {f"{k}.{sub}" for sub in _keys(v, depth - 1)}
    return out


def test_slo_and_costz_payload_keys_match_the_jax_server(model):
    """The same two greedy requests through both Servers (default cost on,
    declared objectives): the /slo, /costz.json and /statusz documents carry
    the JAX Server's keys, but for the per-program rows (the JAX engine notes
    its compiles; the port has no harvest and no compile before A13)."""
    declared = ({"name": "turn_latency", "kind": "latency", "latency_ms": 5000.0,
                 "target": 0.99},)
    srv = Server(model, ServeConfig(chunk=4, slots=2, metrics_port=0, slo=declared))
    jsrv = JaxServer(jax_model(), jax_params(), JaxServeConfig(
        chunk=4, slots=2, metrics_port=0, slo=declared, mesh_audit=False))
    prompts = [np.random.default_rng(i).integers(0, CFG.vocab_size, (1, 5 + i)) for i in range(2)]
    for i, p in enumerate(prompts):
        srv.submit(DecodeRequest(p, 8, GREEDY, seed=i))
        jsrv.submit(JaxDecodeRequest(prompt=jnp.asarray(p, jnp.int32), max_new_tokens=8,
                                     sample=jax_sample(GREEDY), seed=i))
    assert srv.serve(drain_when_idle=True) == jsrv.serve(drain_when_idle=True) == 0
    try:
        for route in ("/slo", "/costz.json"):
            got = json.loads(_get(f"http://127.0.0.1:{srv.http_port}{route}")[1])
            want = json.loads(_get(f"http://127.0.0.1:{jsrv.http_port}{route}")[1])
            # the ledger's entries and compile times are per program: the JAX
            # engine notes its jit compiles, the port compiles nothing (A13)
            per_program = ("ledger.", "compile_ms.")
            assert ({k for k in _keys(got, 3) if not k.startswith(per_program)}
                    == {k for k in _keys(want, 3) if not k.startswith(per_program)}), route
        assert "turn_latency" in json.loads(_get(f"http://127.0.0.1:{srv.http_port}/slo")[1])[
            "objectives"]
        got = _get(f"http://127.0.0.1:{srv.http_port}/statusz")[1]
        want = _get(f"http://127.0.0.1:{jsrv.http_port}/statusz")[1]
        sections = [ln for ln in want.splitlines() if ln.startswith("[")]
        assert all(s in got for s in sections if s not in ("[compile_cache]",)), sections
    finally:
        srv.close()
        jsrv.close()


_CHUNK_SLO = ({"name": "chunk_lat", "kind": "latency", "source": "chunk", "latency_ms": 8.0,
               "target": 0.9, "fast_window_s": 0.25, "slow_window_s": 0.75, "fast_burn": 5.0},)


def test_slo_fast_burn_degrades_and_sheds_early(model):
    """A sustained injected chunk latency fires the fast burn; after
    slo_degrade_ticks boundaries the server degrades itself (the burn is the
    reason) and halves its admission bound: a submit that would have queued
    sheds, its message naming the SLO (the reference's
    tests/test_obs.py:1030)."""
    srv = Server(model, ServeConfig(chunk=4, slots=2, max_inflight=8, slo=_CHUNK_SLO,
                                    slo_degrade_ticks=3))
    srv.submit(DecodeRequest(np.arange(5)[None], 64, GREEDY, seed=0))
    overloads = []
    with inject.inject(inject.FaultPlan().delay_chunk(0.04, times=-1)):
        th = threading.Thread(target=lambda: srv.serve(drain_when_idle=True), daemon=True)
        th.start()
        deadline = time.monotonic() + 30.0
        while not srv._slo_shedding and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv._slo_shedding, "a sustained burn must arm early shedding"
        for i in range(8):
            try:
                srv.submit(DecodeRequest(np.arange(3 + i)[None], 4, GREEDY, seed=100 + i))
            except OverloadError as e:
                overloads.append(str(e))
        th.join(timeout=60.0)
    assert not th.is_alive()
    assert overloads and "slo fast burn" in overloads[0], overloads
    assert any("slo fast burn" in r for _, _, r, _ in srv.health.history)
    assert srv.metrics.counter("slo_alerts").value(labels={"alert": "fast"}) >= 1
    assert any(e.get("alert") == "shedding" for e in srv.flight.events("slo"))
    srv.close()
