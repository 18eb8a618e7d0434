"""The train and generate CLIs under torchrun with tp, on gloo CPU ranks.

- ``torchrun --nproc_per_node 4 -m orion_tpu_torch.train --distributed
  --tp 2 --fsdp 2 --device cpu`` and ``... --tp 2 --sp 2`` (a linear,
  softmax, swa, linear model, sequence-parallel): rank 0 alone prints the
  metrics, which equal a one-rank run's within 2e-5; each rank prints its
  transport (gloo); the checkpoint is the file the one-rank run writes (the
  same keys, params and AdamW moments within 2e-5). The one-rank Trainer is
  held against the JAX package's at these meshes in
  ``tests/test_torch_tp_trainer.py`` and ``tests/test_torch_tp_models.py``.
- ``torchrun --nproc_per_node 2 -m orion_tpu_torch.generate --distributed
  --tp 2 --device cpu`` prints a one-rank run's greedy text, once (rank 0).
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_sp_workers import _free_port

SP_OVER = {"model": {"layer_types": ["linear", "softmax", "swa", "linear"], "n_layers": 4,
                     "d_model": 64, "n_heads": 2, "window": 8, "dtype": "float32",
                     "ring_striped": True, "max_seq_len": 128}}
TP_OVER = {"model": {"d_model": 64, "n_heads": 2, "n_layers": 2, "dtype": "float32"}}


def _env():
    env = dict(os.environ, PYTHONPATH=os.getcwd(), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def _torchrun(n, args):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
         "--master_port", str(_free_port()), *args], env=_env(), capture_output=True, text=True,
        timeout=240)


@pytest.mark.parametrize("mesh,over", [(["--tp", "2", "--fsdp", "2"], TP_OVER),
                                       (["--tp", "2", "--sp", "2", "--set",
                                         "model.sequence_parallel=true"], SP_OVER)],
                         ids=["tp2 fsdp2", "tp2 sp2"])
def test_train_cli_under_torchrun_matches_one_rank(tmp_path, mesh, over):
    path = tmp_path / "over.json"
    path.write_text(json.dumps(over))
    common = ["-m", "orion_tpu_torch.train", "--device", "cpu", "--config", "tiny", "--steps",
              "2", "--seq-len", "64", "--batch-size", "4", "--config-json", str(path)]
    tp = _torchrun(4, [*common, "--distributed", *mesh, "--ckpt-dir", str(tmp_path / "tp")])
    one = subprocess.run([sys.executable, *common, "--ckpt-dir", str(tmp_path / "one")],
                         env=_env(), capture_output=True, text=True, timeout=240)
    assert tp.returncode == 0 and one.returncode == 0, tp.stderr[-3000:] + one.stderr[-3000:]
    assert tp.stderr.count("transport gloo") == 4
    printed = [[ast.literal_eval(line) for line in run.stdout.splitlines() if line.startswith("{")]
               for run in (tp, one)]
    assert len(printed[0]) == len(printed[1]) == 1
    assert printed[0][0] == pytest.approx(printed[1][0], rel=2e-5, abs=2e-5)
    files = [sorted(p.name for p in (tmp_path / d).glob("*.pt")) for d in ("tp", "one")]
    assert files[0] == files[1] == ["step-00000002.pt"]
    a, b = (torch.load(tmp_path / d / "step-00000002.pt", map_location="cpu")
            for d in ("tp", "one"))
    assert int(a["step"]) == int(b["step"]) == 2
    assert a["params"].keys() == b["params"].keys()
    for n, p in b["params"].items():
        torch.testing.assert_close(a["params"][n], p, rtol=2e-5, atol=2e-5)
    for key in ("mu", "nu"):
        for n, t in b["opt"][key].items():
            torch.testing.assert_close(a["opt"][key][n], t, rtol=2e-5, atol=2e-5)


def test_generate_cli_under_torchrun_prints_the_tp1_text():
    common = ["-m", "orion_tpu_torch.generate", "--device", "cpu", "--config", "tiny",
              "--prompt", "Hello", "--max-new-tokens", "12", "--temperature", "0"]
    tp = _torchrun(2, [*common, "--distributed", "--tp", "2"])
    one = subprocess.run([sys.executable, *common], env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert tp.returncode == 0 and one.returncode == 0, tp.stderr[-3000:] + one.stderr[-3000:]
    assert tp.stderr.count("transport gloo") == 2
    assert tp.stdout.splitlines() == one.stdout.splitlines()
    assert len(one.stdout.splitlines()) == 1 and one.stdout.startswith("Hello")
