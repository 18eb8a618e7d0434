"""The port's cost attribution, capacity model and on-demand profiling
(``orion_tpu_torch/obs/cost.py``, their wiring in ``serving/server.py``,
``utils/profiling.py``) against the JAX package's on the CPU.

- ``attribute_chunk``, ``CapacityModel.state()``, ``fleet_capacity`` and
  ``check_snapshot_cost`` / ``python -m ... obs.cost check``: the same
  numpy-drawn inputs give results equal to the JAX package's, exactly;
- a default ``Server`` at ``tiny`` (cost on) against the JAX ``Server`` on
  the converted weights, unquantized (fp32, as ``tiny`` is), int8 and int4:
  every result's prefill / decode tokens and flops, and the analytic
  ``flops_per_decode_step`` / ``flops_per_prefill_token`` (2 x the JAX
  package's leaf count of the served tree), equal; greedy tokens equal;
- conservation: the requests' ``device_ms`` add up to the boundaries'
  ``chunk_ms`` within the reference's 1e-6 under stagger, in-scan prefill, a
  ladder rung and speculative rounds, and by host admission;
- ``/costz``, ``/metrics`` and ``/statusz`` carry the cost surfaces;
  ``/profilez`` arms a ``torch.profiler`` capture that writes a Chrome trace
  on the CPU (409 while one is armed or when disabled, 400 for a bad count);
  a solo ``DecodeSession`` reports zero cost.

Tolerances: exact for the copied modules and the token counts; 1e-6
relative for conservation (the 6-decimal stamping), as the reference's
``tests/test_cost.py``.
"""

import contextlib
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.obs import cost as jax_cost
from orion_tpu.serving import DecodeRequest as JaxDecodeRequest
from orion_tpu.serving import ServeConfig as JaxServeConfig
from orion_tpu.serving import Server as JaxServer
from orion_tpu_torch.obs import cost
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.serving import DecodeRequest, DecodeSession, ServeConfig, Server
from orion_tpu_torch.utils.profiling import TRACE_FILE
from torch_serving_common import CFG, GREEDY, torch_model

torch.set_num_threads(2)
CONSERVATION = 1e-6  # |sum(device_ms) - sum(chunk_ms)| / sum(chunk_ms), as the reference


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _get(url, timeout=10.0):
    try:
        r = urllib.request.urlopen(url, timeout=timeout)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _conservation(srv, results):
    attributed = sum(r.device_ms for r in results)
    cell = srv._h_chunk_ms.cell_total()
    assert cell is not None and cell["sum"] > 0
    return abs(attributed - cell["sum"]) / cell["sum"]


# -- the copied units against the JAX package ------------------------------------------------


def _ledger(pkg, rng, record):
    led = pkg.CostLedger(slots=4, chunk=8, prefill_chunk=16, spec_depth=2,
                         fallback_flops_per_token=float(rng.integers(100, 1000)))
    if record:
        for kind in ("decode_batched", "unified_prefill", "spec_round"):
            led.record(kind, f"{kind}(k)", flops=float(rng.integers(1000, 100000)))
    return led


def _rows(rng, n):
    rows = []
    for i in range(n):
        kind = rng.integers(0, 5)
        row = {"tag": i, "decode_steps": 0, "prefill_tokens": 0, "decode_tokens": 0}
        if kind == 0:
            row.update(decode_steps=8, decode_tokens=8)
        elif kind == 1:
            row.update(prefill_tokens=int(rng.integers(1, 17)))
        elif kind == 2:
            row.update(frozen=True)
        elif kind == 3:
            row.update(spec_round=True, decode_tokens=int(rng.integers(1, 4)))
        else:
            row.update(failed=True, decode_steps=8)
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_attribute_chunk_matches_the_jax_package(seed):
    for record in (False, True):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        led, jled = _ledger(cost, rng, record), _ledger(jax_cost, jrng, record)
        assert led.flops_per_decode_step() == jled.flops_per_decode_step()
        assert led.flops_per_prefill_token() == jled.flops_per_prefill_token()
        assert led.flops_per_spec_round() == jled.flops_per_spec_round()
        for n in (0, 1, 4):
            rows = _rows(rng, n)
            dt = float(rng.uniform(1, 50))
            got = [(e["tag"], s, f) for e, s, f in cost.attribute_chunk(led, dt, rows)]
            want = [(e["tag"], s, f) for e, s, f in jax_cost.attribute_chunk(jled, dt, rows)]
            assert got == want
            if rows:
                assert sum(s for _, s, _ in got) == pytest.approx(dt, abs=1e-12)


@pytest.mark.parametrize("window", [2.0, 10.0])
def test_capacity_model_state_matches_the_jax_package(window):
    """Both models over one scripted feed (boundaries into numpy-drawn
    buckets, a saturating phase, idle time): state() equal at every tick."""
    now, counts, tokens = [0.0], [0, 0, 0, 0], [0.0]
    buckets = (1.0, 2.0, 5.0, float("inf"))
    mk = lambda pkg: pkg.CapacityModel(  # noqa: E731
        slots=2, chunk=4, buckets=buckets, read_chunk_counts=lambda: tuple(counts),
        read_tokens=lambda: tokens[0], clock=lambda: now[0], window_s=window, slice_s=1.0)
    port, ref = mk(cost), mk(jax_cost)
    rng = np.random.default_rng(5)
    for step in range(60):
        now[0] += 0.5
        if step < 40:
            counts[int(rng.integers(0, 4))] += 1
            tokens[0] += 4.0 if step < 20 else 100000.0
        assert port.tick() == ref.tick(), step
    assert port.state() == ref.state()


_FLEET_GAUGES = {
    "two": [("capacity_tokens_per_s", 1000.0), ("capacity_current_tokens_per_s", 900.0),
            ("capacity_tokens_per_s", 1000.0), ("capacity_current_tokens_per_s", 100.0),
            ("capacity_headroom", 1.0)],
    "saturated": [("capacity_tokens_per_s", 10.0), ("capacity_current_tokens_per_s", 50.0)],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(_FLEET_GAUGES))
def test_fleet_capacity_matches_the_jax_package(case):
    agg = {"gauges": [{"name": n, "labels": {}, "value": v} for n, v in _FLEET_GAUGES[case]]}
    assert cost.fleet_capacity(agg) == jax_cost.fleet_capacity(agg)


def _cost_snap(headroom=None, chunk_sum=None, attributed=None):
    doc = {"counters": [], "gauges": [], "histograms": []}
    if headroom is not None:
        doc["gauges"].append({"name": "capacity_headroom", "labels": {}, "value": headroom})
    if chunk_sum is not None:
        doc["histograms"].append({"name": "chunk_ms", "labels": {}, "buckets": [1, "+Inf"],
                                  "counts": [3, 0], "sum": chunk_sum, "count": 3})
    if attributed is not None:
        doc["counters"].append({"name": "attributed_ms_total", "labels": {},
                                "value": attributed})
    return doc


_COST_CHECKS = {
    "healthy": ((0.6, 100.0, 100.0), ["--min-headroom", "0.5"], 0),
    "headroom": ((0.2, 100.0, 100.0), ["--min-headroom", "0.5"], 1),
    "conservation": ((0.9, 100.0, 80.0), [], 1),
    "within_bound": ((0.9, 100.0, 99.0), [], 0),
    "no_data": ((None, None, None), ["--min-headroom", "0.9"], 0),
}


@pytest.mark.parametrize("case", sorted(_COST_CHECKS))
def test_cost_check_matches_the_jax_package(tmp_path, capsys, case):
    values, flags, rc = _COST_CHECKS[case]
    doc = _cost_snap(*values)
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(doc))
    assert cost.check_snapshot_cost(doc, 0.5) == jax_cost.check_snapshot_cost(doc, 0.5)
    got = cost.main(["check", *flags, str(path)]), capsys.readouterr().out
    want = jax_cost.main(["check", *flags, str(path)]), capsys.readouterr().out
    assert got == want and got[0] == rc


# -- the Server against the JAX Server -------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    """``tiny`` in both packages: the JAX package's seeded init and the port's
    model on the same weights (converted)."""
    import jax

    from orion_tpu.models.configs import get_config as jax_config
    from orion_tpu.models.transformer import TransformerLM as JaxLM
    from orion_tpu_torch.convert import load_jax_params
    from orion_tpu_torch.models.configs import TINY
    from orion_tpu_torch.models.transformer import TransformerLM

    jmodel = JaxLM(jax_config("tiny"))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree.map(np.asarray, params)
    return jmodel, params, load_jax_params(TransformerLM(TINY, device="cpu"), dict(tree))


@pytest.mark.parametrize("qmode", ["off", "int8", "int4"])
def test_default_server_cost_matches_the_jax_server(tiny_pair, qmode):
    """The same five requests (prompts of 3-40 tokens, 16 new tokens) into a
    default Server of each package (cost on, the JAX Server's library
    default of no ledger harvest): each result's prefill / decode tokens and
    flops equal, the flops weights equal, the greedy tokens equal; the
    port's device_ms conserve chunk_ms."""
    jmodel, params, model = tiny_pair
    lengths = (3, 17, 40, 9, 25)
    prompts = [np.random.default_rng(70 + i).integers(0, 256, (1, n))
               for i, n in enumerate(lengths)]
    srv = Server(model, ServeConfig(qmode=qmode))
    jsrv = JaxServer(jmodel, params, JaxServeConfig(qmode=qmode))
    ps = [srv.submit(DecodeRequest(p, 16, GREEDY, seed=i)) for i, p in enumerate(prompts)]
    jps = [jsrv.submit(JaxDecodeRequest(prompt=jnp.asarray(p, jnp.int32), max_new_tokens=16,
                                        sample=jax_sample_greedy(), seed=i))
           for i, p in enumerate(prompts)]
    assert srv.serve(drain_when_idle=True) == jsrv.serve(drain_when_idle=True) == 0
    for i, (p, jp) in enumerate(zip(ps, jps)):
        r, jr = p.result, jp.result
        assert (r.prefill_tokens, r.decode_tokens) == (jr.prefill_tokens, jr.decode_tokens) == (
            lengths[i], 16), i
        assert r.cost_flops == jr.cost_flops, i
        np.testing.assert_array_equal(r.tokens, np.asarray(jr.tokens), err_msg=f"request {i}")
    attr, jattr = srv._costz()["attribution"], jsrv._costz()["attribution"]
    for key in ("flops_per_decode_step", "flops_per_prefill_token", "decode_tokens_total",
                "prefill_tokens_total"):
        assert attr[key] == jattr[key], key
    assert _conservation(srv, [p.result for p in ps]) < CONSERVATION
    srv.close()
    jsrv.close()


def jax_sample_greedy():
    from orion_tpu.generate import SampleConfig as JaxSampleConfig

    return JaxSampleConfig(temperature=0.0)


# -- conservation inside the port -----------------------------------------------------------


_SCENARIOS = {
    # staggered admission (3 requests > 2 slots), in-scan prefill, a rung-1
    # replay in slot 0 at chunk 2
    "inscan_ladder": dict(cfg=dict(prefill_chunk=8), new=12,
                          plan=lambda: inject.FaultPlan().poison_decode_slot_at(0, 2, times=1)),
    # speculative rounds at the pure-decode boundaries
    "spec": dict(cfg=dict(prefill_chunk=0, spec_depth=2, spec_min_accept=0.0), new=10,
                 plan=None),
    # host admission, every prompt in one bucket
    "host": dict(cfg=dict(prefill_chunk=0, prefill_buckets="8,16,32"), new=9, plan=None),
}


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_attribution_conserves_chunk_ms(model, scenario):
    sc = _SCENARIOS[scenario]
    srv = Server(model, ServeConfig(chunk=4, slots=2, max_inflight=8, **sc["cfg"]))
    ps = [srv.submit(DecodeRequest(np.random.default_rng(40 + i).integers(
        0, CFG.vocab_size, (1, 4 + 2 * i)), sc["new"], GREEDY, seed=i)) for i in range(3)]
    with inject.inject(sc["plan"]()) if sc["plan"] else contextlib.nullcontext():
        assert srv.serve(drain_when_idle=True) == 0
    results = [p.result for p in ps]
    assert [r.status for r in results] == ["ok"] * 3
    if scenario == "inscan_ladder":
        assert sum(r.rewinds for r in results) >= 1, "rung 1 engaged"
    if scenario == "spec":
        assert srv.metrics.counters_flat()["spec_accepted_total"] > 0
    assert _conservation(srv, results) < CONSERVATION
    for p, r in zip(ps, results):
        assert r.device_ms > 0 and r.cost_flops > 0 and r.decode_tokens >= sc["new"]
        if scenario == "inscan_ladder":  # in-scan admission bills exactly the prompt
            assert r.prefill_tokens == p.request.prompt.shape[-1]
            assert r.decode_tokens == sc["new"]
        else:  # a host prefill runs at admission, outside the boundaries
            assert r.prefill_tokens == 0
    assert srv._h_req_device_ms.cell()["count"] == srv._h_req_flops.cell()["count"] == 3
    srv.close()


def test_solo_decode_session_reports_zero_cost(model):
    r = DecodeSession(model, chunk=4).run(DecodeRequest(np.arange(5)[None], 8, GREEDY, seed=1))
    assert r.status == "ok"
    assert (r.device_ms, r.cost_flops, r.prefill_tokens, r.decode_tokens) == (0.0, 0.0, 0, 0)


# -- the endpoints and on-demand profiling ----------------------------------------------------


def test_costz_and_profilez_endpoints(model, tmp_path):
    srv = Server(model, ServeConfig(chunk=4, slots=2, prefill_chunk=8, metrics_port=0,
                                    profile_dir=str(tmp_path / "prof")))
    url = f"http://127.0.0.1:{srv.http_port}"
    code, body = _get(url + "/profilez?chunks=2")
    assert code == 200 and json.loads(body)["armed"] == 2
    assert _get(url + "/profilez?chunks=1")[0] == 409, "one capture at a time"
    assert _get(url + "/profilez?chunks=bogus")[0] == 400
    p = srv.submit(DecodeRequest(np.arange(6)[None], 12, GREEDY, seed=0))
    assert srv.serve(drain_when_idle=True) == 0 and p.result.status == "ok"
    doc = json.loads(_get(url + "/costz.json")[1])
    assert doc["enabled"] and doc["capacity"]["no_data"] is False
    assert doc["attribution"]["attributed_ms_total"] > 0
    artifact = doc["profile"]["last_artifact"]
    assert artifact and doc["profile"]["active_chunks_left"] == 0
    trace = json.loads(open(f"{artifact}/{TRACE_FILE}").read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::linear" in names or "aten::addmm" in names or "aten::mm" in names, \
        "the capture holds the CPU ops of the profiled boundaries"
    events = [e for e in srv.flight.events("profile")]
    assert [e["event"] for e in events] == ["armed", "start", "stop"]
    code, body = _get(url + "/costz")
    assert code == 200 and "[ledger]" in body and "[capacity]" in body
    body = _get(url + "/metrics")[1]
    assert "capacity_headroom" in body and "attributed_ms_total" in body
    assert "[cost]" in _get(url + "/statusz")[1]
    srv.close()
    srv2 = Server(model, ServeConfig(chunk=4, slots=2, metrics_port=0))
    code, body = _get(f"http://127.0.0.1:{srv2.http_port}/profilez?chunks=2")
    assert code == 409 and "disabled" in json.loads(body)["error"]
    srv2.close()
