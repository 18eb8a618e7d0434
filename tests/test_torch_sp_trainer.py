"""The port's Trainer at sp 4 (four gloo CPU ranks) held against the JAX
package's Trainer at ``MeshConfig(dp=1, sp=4)``, on the CPU.

The configuration is ``tests/test_sharding.py::test_trainer_sequence_parallel_parity``'s:
layer types linear, softmax, swa, window 6, fp32, sequence_parallel, with
the softmax layer through the contiguous ring and through the striped one.
The JAX Trainer draws its params; the port's ranks (``tests/torch_sp_workers.py``:
processes that import torch and the port, never JAX) load them through
``convert.py`` and take the same two synthetic batches. On the CPU both run
their plain forms: the two-pass linear body, the einsum rings, the windowed
ring for swa (the JAX package's XLA forms). The loss of each step and every
param after the two steps are compared at the JAX test's own tolerances:
2e-5 for the loss, 3e-5 for the params, both relative and absolute. Every
rank ends with the same params.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_sp_workers as workers
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from orion_tpu.training.data import SyntheticDataset
from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
from orion_tpu.training.trainer import Trainer as JaxTrainer
from orion_tpu_torch.convert import params_from_jax
from orion_tpu_torch.models.configs import ModelConfig

SP = 4
KW = dict(steps=2, batch_size=4, seq_len=32, lr=1e-3, warmup_steps=1, log_every=100)
MODEL = dict(name="sp_test", vocab_size=64, d_model=32, n_layers=3, n_heads=2, max_seq_len=64,
             dtype="float32", layer_types=("linear", "softmax", "swa"), window=6,
             sequence_parallel=True, chunk=8)
STRIPED = (False, True)


def _batches():
    ds = SyntheticDataset(64, 32)
    return [np.asarray(ds.batch(0, i, 4)) for i in range(2)]


@functools.lru_cache(maxsize=None)
def _jax_runs():
    runs = []
    for striped in STRIPED:
        cfg = JaxModelConfig(backend="xla", ring_striped=striped, **MODEL)
        tr = JaxTrainer(JaxTrainConfig(model=cfg, mesh=JaxMeshConfig(dp=1, sp=SP), **KW))
        tree = jax.device_get(tr.state.params)
        losses = [float(tr.step(jnp.asarray(b))["loss"]) for b in _batches()]
        runs.append((tree, losses, jax.device_get(tr.state.params)))
    return runs


@functools.lru_cache(maxsize=None)
def _port_runs():
    payload = {"kw": KW, "runs": [{"model": ModelConfig(ring_striped=s, **MODEL), "tree": tree,
                                   "batches": _batches()}
                                  for s, (tree, _, _) in zip(STRIPED, _jax_runs())]}
    return workers.run_ranks(SP, workers.mesh_runs, payload, timeout=240)


@pytest.mark.parametrize("i,striped", list(enumerate(STRIPED)))
def test_sp4_trainer_matches_the_jax_sp4_trainer(i, striped):
    _, want_losses, want_params = _jax_runs()[i]
    ranks = [r[i] for r in _port_runs()]
    model = ModelConfig(ring_striped=striped, **MODEL)
    ref = params_from_jax(want_params, model)
    for losses, _, params, _ in ranks:
        np.testing.assert_allclose(losses, want_losses, rtol=2e-5, atol=2e-5)
        for n, p in params.items():
            np.testing.assert_allclose(p, ref[n].numpy(), rtol=3e-5, atol=3e-5, err_msg=n)
    for _, _, params, _ in ranks[1:]:  # the ranks agree bitwise
        for n, p in params.items():
            np.testing.assert_array_equal(p, ranks[0][2][n], err_msg=n)


def test_sp_needs_its_process_group_and_sequence_parallel():
    from orion_tpu_torch.training.trainer import MeshConfig, TrainConfig, Trainer

    cfg = TrainConfig(model=ModelConfig(**MODEL), mesh=MeshConfig(dp=1, sp=4), **KW)
    with pytest.raises(ValueError, match="init_distributed"):
        Trainer(cfg, device="cpu")
    # tp and pp are ported (tests/test_torch_tp*.py, tests/test_torch_pp*.py)
    # and need their group too; ep is not
    with pytest.raises(ValueError, match="init_distributed"):
        Trainer(dataclasses.replace(cfg, mesh=MeshConfig(dp=1, sp=2, tp=2)), device="cpu")
    with pytest.raises(ValueError, match="init_distributed"):
        Trainer(dataclasses.replace(cfg, mesh=MeshConfig(dp=1, sp=2, pp=2)), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        Trainer(dataclasses.replace(cfg, mesh=MeshConfig(dp=1, sp=2, ep=2)), device="cpu")


def test_train_cli_under_torchrun_matches_one_rank(tmp_path):
    """``torchrun --nproc_per_node 2 -m orion_tpu_torch.train --distributed
    --sp 2 --device cpu``: rank 0 alone prints the metrics, which equal an
    sp=1 run's within 2e-5, and its checkpoint is the file an
    sp=1 run writes, with the same params (2e-5)."""
    import ast
    import json
    import os
    import subprocess
    import sys

    import torch

    from torch_sp_workers import _free_port

    over = tmp_path / "over.json"
    over.write_text(json.dumps({"model": {
        "layer_types": ["linear", "softmax", "swa", "linear"], "n_layers": 4, "d_model": 64,
        "n_heads": 2, "window": 8, "dtype": "float32", "ring_striped": True,
        "max_seq_len": 128}}))
    common = ["-m", "orion_tpu_torch.train", "--device", "cpu", "--config", "tiny", "--steps",
              "2", "--seq-len", "64", "--batch-size", "2", "--config-json", str(over)]
    env = dict(os.environ, PYTHONPATH=os.getcwd(), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    sp = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", str(_free_port()), *common, "--distributed", "--sp", "2",
         "--set", "model.sequence_parallel=true", "--ckpt-dir", str(tmp_path / "sp")],
        env=env, capture_output=True, text=True, timeout=240)
    one = subprocess.run([sys.executable, *common, "--ckpt-dir", str(tmp_path / "one")],
                         env=env, capture_output=True, text=True, timeout=240)
    assert sp.returncode == 0 and one.returncode == 0, sp.stderr[-3000:] + one.stderr[-3000:]
    assert sp.stderr.count("transport gloo") == 2
    printed = [[ast.literal_eval(line) for line in run.stdout.splitlines() if line.startswith("{")]
               for run in (sp, one)]
    assert len(printed[0]) == len(printed[1]) == 1
    assert printed[0][0] == pytest.approx(printed[1][0], rel=2e-5, abs=2e-5)
    files = [sorted(p.name for p in (tmp_path / d).glob("*.pt")) for d in ("sp", "one")]
    assert files[0] == files[1] == ["step-00000002.pt"]
    a, b = (torch.load(tmp_path / d / "step-00000002.pt", map_location="cpu")
            for d in ("sp", "one"))
    assert int(a["step"]) == int(b["step"]) == 2
    for n, p in b["params"].items():
        torch.testing.assert_close(a["params"][n], p, rtol=2e-5, atol=2e-5)
