"""The port's training ``MetricsLogger`` against the JAX package's on the
CPU: the same ``log`` calls, with ``time.perf_counter`` patched to the same
readings in both modules and registries on the same fake clock, give a
dumped registry whose Prometheus text and JSON are byte-equal to
``orion_tpu.training.metrics.MetricsLogger``'s, and the same JSONL lines;
the train CLI's ``--metrics-path`` dump is the registry's."""

import io
import json
from pathlib import Path

import pytest

from orion_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from orion_tpu.training import metrics as jax_metrics
from orion_tpu_torch.obs.metrics import MetricsRegistry
from orion_tpu_torch.training import metrics

CALLS = [
    (1, {"loss": 5.25, "grad_norm": 3.0, "lr": 0.0, "nonfinite": 0.0}, 64),
    (2, {"loss": 4.75, "grad_norm": 2.5, "lr": 1e-4, "nonfinite": 0.0}, 64),
    (2, {"eval_loss": 4.5, "eval_ppl": 90.0171313}, 0),
    (5, {"loss": 3.125, "grad_norm": 1.75, "lr": 2e-4, "nonfinite": 1.0}, 64),
    (7, {"loss": float("inf"), "grad_norm": float("nan"), "lr": 3e-4}, 64),
    (8, {"loss": 2.0, "ppl": 7.38905609893065, "lr": 3e-4}, 0),
]
TIMES = [10.0, 10.03125, 10.25, 10.5, 12.75, 12.875]


def _run(module, registry, path, monkeypatch):
    times = iter(TIMES)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(times))
    logger = module.MetricsLogger(str(path / "m.jsonl"), stream=io.StringIO(), registry=registry)
    for step, m, tokens in CALLS:
        logger.log(step, m, tokens)
    logger.dump(str(path / "m.prom"))
    logger.close()
    monkeypatch.undo()
    return logger


@pytest.mark.parametrize("given_registry", [True, False])
def test_dump_byte_equal_to_the_jax_logger(tmp_path, monkeypatch, given_registry):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    clock = lambda: 123.5  # noqa: E731 -- the snapshot's "t"
    a = _run(metrics, MetricsRegistry(clock=clock) if given_registry else None, ours, monkeypatch)
    b = _run(jax_metrics, JaxRegistry(clock=clock) if given_registry else None, theirs,
             monkeypatch)
    if not given_registry:  # a private registry each: align the clocks of the snapshot
        a.registry._clock = b.registry._clock = clock
        a.dump(str(ours / "m.prom"))
        b.dump(str(theirs / "m.prom"))
    for name in ("m.prom", "m.prom.json", "m.jsonl"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    text = (ours / "m.prom").read_text()
    assert "train_steps_total 7\n" in text and 'train{metric="step"} 8\n' in text
    assert "step_time_ms_count 3\n" in text


def test_stdout_line_and_the_eval_fields(monkeypatch, tmp_path):
    out = io.StringIO()
    times = iter([1.0, 1.5])
    monkeypatch.setattr(metrics.time, "perf_counter", lambda: next(times))
    logger = metrics.MetricsLogger(stream=out)
    logger.log(1, {"loss": 2.0}, 10)
    logger.log(2, {"loss": 1.5, "eval_loss": 1.25}, 10)
    lines = out.getvalue().splitlines()
    assert lines[0] == "step       1  loss 2"
    assert lines[1] == "step       2  loss 1.5  tokens_per_sec 20  step_time_ms 500  eval_loss 1.25"


def test_train_cli_metrics_path_dump(tmp_path):
    from orion_tpu_torch.train import main

    prom = tmp_path / "t.prom"
    assert main(["--config", "tiny", "--device", "cpu", "--steps", "2", "--batch-size", "2",
                 "--seq-len", "16", "--set", "model.n_layers=1", "--set", "model.d_model=32",
                 "--set", "model.n_heads=2", "--set", "log_every=1",
                 "--metrics-path", str(prom)]) == 0
    snap = json.loads(Path(str(prom) + ".json").read_text())
    counters = {c["name"]: c["value"] for c in snap["counters"]}
    assert counters == {"train_steps_total": 1}
    gauges = {g["labels"]["metric"]: g["value"] for g in snap["gauges"] if g["name"] == "train"}
    assert gauges["step"] == 2 and {"loss", "grad_norm", "lr", "ppl"} <= gauges.keys()
