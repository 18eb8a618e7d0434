"""The train CLI's resilience knobs on the CPU, as the JAX package's
(``tests/test_resilience.py::test_train_cli_resilience_knobs``):
``--preempt-grace``, ``--step-timeout`` and ``--metrics-path`` reach the run
(a watchdog'd run completes and dumps its registry), and a real SIGTERM to
``python -m orion_tpu_torch.train --ckpt-dir D`` mid-run exits 0 with an
emergency checkpoint and ``preempted at step N``; the rerun resumes from it
and ends on a checkpoint bitwise, tensor by tensor, the uninterrupted CLI's.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from orion_tpu_torch import train as train_mod
from orion_tpu_torch.training.checkpoint import Checkpointer, step_path

pytestmark = pytest.mark.chaos
torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _equal(a, b):
    for n in a:
        assert torch.equal(a[n], b[n]), n


_CLI = ["--config", "tiny", "--device", "cpu", "--batch-size", "2", "--seq-len", "16",
        "--set", "model.n_layers=1", "--set", "model.d_model=32", "--set", "model.n_heads=2",
        "--set", "model.vocab_size=64", "--set", "log_every=1", "--set", "ckpt_every=1000"]


def test_train_cli_resilience_knobs(tmp_path, capsys):
    """--preempt-grace / --step-timeout / --metrics-path reach the run; a
    watchdog'd run completes when nothing stalls, and dumps its registry."""
    args = train_mod.build_argparser().parse_args(
        ["--preempt-grace", "7.5", "--step-timeout", "120", "--metrics-path", "m.prom"])
    assert (args.preempt_grace, args.step_timeout, args.metrics_path) == (7.5, 120.0, "m.prom")
    assert train_mod.build_argparser().parse_args([]).preempt_grace == 10.0
    prom = str(tmp_path / "m.prom")
    rc = train_mod.main([*_CLI, "--steps", "3", "--preempt-grace", "30", "--step-timeout", "300",
                         "--metrics-path", prom])
    assert rc == 0
    text = Path(prom).read_text()
    assert "train_steps_total 2\n" in text and 'train{metric="step"} 3\n' in text
    snap = json.loads(Path(prom + ".json").read_text())
    assert any(h["name"] == "step_time_ms" and h["count"] == 2 for h in snap["histograms"])


def _cli(args, env):
    return subprocess.Popen([sys.executable, "-m", "orion_tpu_torch.train", *_CLI, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(ROOT))


def test_sigterm_to_the_cli_then_rerun_is_bitwise_the_uninterrupted_run(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    d, log = tmp_path / "d", tmp_path / "l.jsonl"
    steps = ["--steps", "400"]
    cli = _cli([*steps, "--ckpt-dir", str(d), "--log-path", str(log)], env)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and cli.poll() is None:
        if log.exists() and len(log.read_text().splitlines()) >= 3:
            cli.send_signal(signal.SIGTERM)
            break
        time.sleep(0.02)
    _, err = cli.communicate(timeout=120)
    assert cli.returncode == 0, err
    n = int(err.split("preempted at step ")[1].split(":")[0])
    assert 3 <= n < 400 and "emergency checkpoint saved" in err
    assert Checkpointer(str(d)).all_steps() == [n]  # ckpt_every=1000: the emergency save
    _, err2 = _cli([*steps, "--ckpt-dir", str(d)], env).communicate(timeout=180)
    assert f"resumed from step {n}" in err2, err2
    assert train_mod.main([*_CLI, *steps, "--ckpt-dir", str(tmp_path / "u")]) == 0
    got, want = (torch.load(step_path(str(x), 400), weights_only=True) for x in (d, tmp_path / "u"))
    for key in ("params", "opt"):
        for name, t in want[key].items():
            if isinstance(t, dict):
                _equal(got[key][name], t)
            else:
                assert torch.equal(got[key][name], t), (key, name)
