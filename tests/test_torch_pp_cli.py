"""The train CLI under torchrun with pp, and a pp checkpoint served and
evaluated, on gloo CPU ranks.

- ``torchrun --nproc_per_node 4 -m orion_tpu_torch.train --distributed
  --pp 2 --dp 2 --device cpu`` (``tiny`` narrowed, fp32, 4 blocks, a batch
  of 16 at the auto n_micro, 8): rank 0
  alone prints the metrics, which equal a one-rank run's within 2e-5; each
  rank prints its transport (gloo); the checkpoint is the file the one-rank
  run writes (the same keys, params and AdamW moments within 2e-5). The
  Trainer is held against the JAX package's at pp meshes in
  ``tests/test_torch_pp_trainer.py``.
- That checkpoint loaded and evaluated by ``orion_tpu_torch.evaluate``'s
  ``load_model`` / ``evaluate_lm`` (the evaluate CLI's path: a pp=1 model of
  the file) gives the eval loss of a pp 2 x dp 2 Trainer that restores it
  (four spawned ranks, ``tests/torch_pp_workers.py``) and evaluates the same
  batches through the pipeline (2e-5), and that Trainer's params are the
  file's, bitwise.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_pp_workers as pp_workers
import torch_sp_workers as workers
from torch_sp_workers import _free_port

OVER = {"model": {"d_model": 64, "n_heads": 2, "n_layers": 4, "dtype": "float32"}}
# 16 rows: the auto n_micro (the JAX rule's 8) leaves each dp rank whole rows
EVAL = dict(batch_size=16, seq_len=64, n_batches=3)


def _env():
    env = dict(os.environ, PYTHONPATH=os.getcwd(), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_cli")
    path = tmp / "over.json"
    path.write_text(json.dumps(OVER))
    common = ["-m", "orion_tpu_torch.train", "--device", "cpu", "--config", "tiny", "--steps",
              "2", "--seq-len", "64", "--batch-size", "16", "--config-json", str(path)]
    pp = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
         "--master_port", str(_free_port()), *common, "--distributed", "--pp", "2", "--dp", "2",
         "--ckpt-dir", str(tmp / "pp")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    one = subprocess.run([sys.executable, *common, "--ckpt-dir", str(tmp / "one")], env=_env(),
                         capture_output=True, text=True, timeout=240)
    out, err = pp.communicate(timeout=240)
    return tmp, subprocess.CompletedProcess(pp.args, pp.returncode, out, err), one


def test_train_cli_under_torchrun_matches_one_rank(cli):
    tmp, pp, one = cli
    assert pp.returncode == 0 and one.returncode == 0, pp.stderr[-3000:] + one.stderr[-3000:]
    assert pp.stderr.count("transport gloo") == 4
    printed = [[ast.literal_eval(line) for line in run.stdout.splitlines() if line.startswith("{")]
               for run in (pp, one)]
    assert len(printed[0]) == len(printed[1]) == 1
    assert printed[0][0] == pytest.approx(printed[1][0], rel=2e-5, abs=2e-5)
    files = [sorted(p.name for p in (tmp / d).glob("*.pt")) for d in ("pp", "one")]
    assert files[0] == files[1] == ["step-00000002.pt"]
    a, b = (torch.load(tmp / d / "step-00000002.pt", map_location="cpu") for d in ("pp", "one"))
    assert int(a["step"]) == int(b["step"]) == 2
    assert a["params"].keys() == b["params"].keys()
    for n, p in b["params"].items():
        torch.testing.assert_close(a["params"][n], p, rtol=2e-5, atol=2e-5)
    for key in ("mu", "nu"):
        assert a["opt"][key].keys() == b["opt"][key].keys()
        for n, t in b["opt"][key].items():
            torch.testing.assert_close(a["opt"][key][n], t, rtol=2e-5, atol=2e-5)


def test_a_pp_checkpoint_evaluates_as_the_pp_trainer_does(cli):
    from orion_tpu_torch.evaluate import evaluate_lm
    from orion_tpu_torch.generate import load_model
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.parallel.mesh import MeshConfig
    from orion_tpu_torch.training.checkpoint import load_params
    from orion_tpu_torch.training.data import make_dataset
    from orion_tpu_torch.training.trainer import TrainConfig

    tmp, pp, _ = cli
    assert pp.returncode == 0, pp.stderr[-3000:]
    model = dataclasses.replace(get_config("tiny"), **OVER["model"])
    loaded, step = load_model(model, str(tmp / "pp"), "cpu")  # a pp=1 model of the file
    assert step == 2
    ds = make_dataset("synthetic", EVAL["seq_len"], model.vocab_size)
    printed = evaluate_lm(loaded, ds, EVAL["batch_size"], EVAL["n_batches"])
    batches = [ds.batch(123, i, EVAL["batch_size"]) for i in range(EVAL["n_batches"])]
    cfg = TrainConfig(model=model, mesh=MeshConfig(dp=2, pp=2), batch_size=EVAL["batch_size"],
                      seq_len=EVAL["seq_len"], steps=2)
    ranks = workers.run_ranks(4, pp_workers.restore_and_evaluate,
                              {"mesh": cfg.mesh, "cfg": cfg, "ckpt": str(tmp / "pp"),
                               "batches": batches})
    saved, _ = load_params(str(tmp / "pp"))
    for step, got, params in ranks:
        assert step == 2
        np.testing.assert_allclose(got["eval_loss"], printed["eval_loss"], rtol=2e-5)
        assert params.keys() == saved.keys()
        for n, t in saved.items():
            np.testing.assert_array_equal(params[n], t.numpy(), err_msg=n)
