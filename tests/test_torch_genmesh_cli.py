"""The generate CLI on meshes under torchrun, and what still refuses on a
mesh, on gloo CPU ranks.

- A ``tiny`` checkpoint from the train CLI, then ``torchrun -m
  orion_tpu_torch.generate --distributed --device cpu --ckpt-dir D`` with
  ``--sp 2`` (2 ranks) and with ``--dp 2 --tp 2 --quant int4`` (4 ranks):
  each prints the one-rank CLI's greedy text (without and with ``--quant
  int4``), once (rank 0), and every rank says its transport (gloo);
- the refusals that stay, each naming its ROADMAP.md A12 step: the serving
  engine's verify and prefill pieces on a sequence-parallel model (step 8),
  and the ep axis (step 8); MoE layers on a sequence-parallel model run.

The library ``generate`` on these meshes against the JAX package:
``tests/test_torch_genmesh*.py``.
"""

import os
import subprocess
import sys

import pytest
import torch

import torch_genmesh_workers as gm_workers
import torch_sp_workers as workers
from orion_tpu_torch.models.configs import ModelConfig, TINY
from orion_tpu_torch.parallel.mesh import Mesh, MeshConfig
from torch_sp_workers import _free_port


def _env():
    env = dict(os.environ, PYTHONPATH=os.getcwd(), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def _start(args, n=0):
    """The command started in the background: under torchrun on ``n`` ranks,
    or alone (``n`` 0)."""
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
                 "--master_port", str(_free_port())] if n else [sys.executable])
    return subprocess.Popen([*launcher, *args], env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """{label: (returncode, stdout, stderr)} of the generate runs from one
    tiny checkpoint, started together."""
    ckpt = tmp_path_factory.mktemp("genmesh_cli") / "ckpt"
    train = subprocess.run([sys.executable, "-m", "orion_tpu_torch.train", "--device", "cpu",
                            "--config", "tiny", "--steps", "2", "--seq-len", "32",
                            "--batch-size", "2", "--ckpt-dir", str(ckpt)],
                           env=_env(), capture_output=True, text=True, timeout=240)
    assert train.returncode == 0, train.stderr[-3000:]
    common = ["-m", "orion_tpu_torch.generate", "--device", "cpu", "--config", "tiny",
              "--ckpt-dir", str(ckpt), "--prompt", "Hello mesh", "--max-new-tokens", "10",
              "--temperature", "0"]
    runs = {"one": _start(common), "one int4": _start([*common, "--quant", "int4"]),
            "sp2": _start([*common, "--distributed", "--sp", "2"], 2),
            "dp2 tp2 int4": _start([*common, "--distributed", "--dp", "2", "--tp", "2",
                                    "--quant", "int4"], 4)}
    out = {}
    for label, proc in runs.items():
        stdout, stderr = proc.communicate(timeout=240)
        out[label] = (proc.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("label,one,ranks", [("sp2", "one", 2), ("dp2 tp2 int4", "one int4", 4)])
def test_generate_cli_on_a_mesh_prints_the_one_rank_text(cli, label, one, ranks):
    rc, stdout, stderr = cli[label]
    rc1, stdout1, stderr1 = cli[one]
    assert rc == 0 and rc1 == 0, stderr[-3000:] + stderr1[-3000:]
    assert stderr.count("transport gloo") == ranks
    assert stderr.count("loaded step 2") == 1  # rank 0 alone reports
    assert stdout.splitlines() == stdout1.splitlines()
    assert len(stdout1.splitlines()) == 1 and stdout1.startswith("Hello mesh")


def test_what_still_refuses_on_a_mesh_names_its_step():
    got = workers.run_ranks(2, gm_workers.refusals,
                            {"mesh": MeshConfig(dp=1, sp=2),
                             "model": ModelConfig(**dict(TINY.__dict__, n_layers=2))})
    for res in got:
        assert res["moe under sp"] is None, res["moe under sp"]
        for piece in ("verify piece on sp", "prefill piece on sp"):
            assert res[piece][0] == "NotImplementedError", res[piece]
            assert "A12 step 8" in res[piece][1]
    from orion_tpu_torch.models.transformer import TransformerLM

    ep = MeshConfig(dp=1, ep=2)
    with pytest.raises(NotImplementedError, match="A12 step 8"):
        TransformerLM(TINY, device="cpu", mesh=Mesh(ep, 0, 2, torch.device("cpu"), "gloo", None))
