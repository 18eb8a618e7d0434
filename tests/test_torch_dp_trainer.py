"""The port's Trainer on four gloo CPU ranks -- dp 2 x fsdp 2, fsdp 4 and
dp 2 x sp 2 -- held against the JAX package's Trainer; a checkpoint
restored across meshes; and the train CLI under torchrun, on the CPU.

One spawn (``tests/torch_sp_workers.py``'s ``mesh_runs``) runs every case,
each on its own mesh of the one process group:

- ``tests/test_sharding.py::test_trainer_parity_across_meshes``'
  configuration (linear + softmax, fp32) at dp 2 x fsdp 2 and at fsdp 4,
  two steps from the JAX Trainer's params, against the JAX Trainer at
  ``MeshConfig(dp=1)`` and at the same mesh on the conftest's virtual CPU
  devices (2e-5 on the loss and every param);
- ``tests/test_torch_sp_trainer.py``'s model (linear, softmax, swa,
  sequence_parallel) at dp 2 x sp 2 against the JAX Trainer at
  ``MeshConfig(dp=2, sp=2)`` (2e-5 on the loss and the params);
- ``tests/test_training.py::test_checkpoint_restores_across_meshes``'
  counterpart: a dp=1 run in this process saves at step 2 and runs to step
  4; a dp 2 x fsdp 2 trainer restores step 2 and runs to step 4, equal to
  the uninterrupted run within 2e-5.

Every rank ends with the same params (bitwise). The CLI: ``torchrun
--nproc_per_node 4 -m orion_tpu_torch.train --distributed --dp 2 --fsdp 2
--device cpu`` prints the metrics of a one-rank run within 2e-5, each rank
prints its transport (gloo), and its checkpoint is the file a one-rank run
writes.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from orion_tpu.training.data import SyntheticDataset
from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
from orion_tpu.training.trainer import Trainer as JaxTrainer
from orion_tpu_torch.convert import params_from_jax
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel.mesh import MeshConfig

_TOL = dict(rtol=2e-5, atol=2e-5)
SHARD = dict(name="shard_test", vocab_size=64, d_model=32, n_layers=2, n_heads=2, max_seq_len=64,
             dtype="float32", layer_types=("linear", "softmax"))
KW = dict(steps=2, batch_size=8, seq_len=16, lr=1e-3, warmup_steps=1, log_every=100)
SP_MODEL = dict(name="sp_test", vocab_size=64, d_model=32, n_layers=3, n_heads=2,
                max_seq_len=64, dtype="float32", layer_types=("linear", "softmax", "swa"),
                window=6, sequence_parallel=True, chunk=8)
SP_KW = dict(steps=2, batch_size=4, seq_len=32, lr=1e-3, warmup_steps=1, log_every=100)
CKPT_KW = dict(KW, steps=4)
DP2F2, FSDP4, DP2SP2 = MeshConfig(dp=2, fsdp=2), MeshConfig(dp=1, fsdp=4), MeshConfig(dp=2, sp=2)


def _batches(n, seq_len=16, b=8):
    ds = SyntheticDataset(64, seq_len)
    return [np.asarray(ds.batch(0, i, b)) for i in range(n)]


def _jax_trainer(model, kw, mesh):
    return JaxTrainer(JaxTrainConfig(model=JaxModelConfig(backend="xla", **model), mesh=mesh,
                                     **kw))


def _steps(tr, batches):
    """The JAX Trainer's losses over ``batches`` and its final params tree."""
    losses = [float(tr.step(jnp.asarray(b))["loss"]) for b in batches]
    return losses, jax.device_get(tr.state.params)


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """The uninterrupted dp=1 run from the seed, saving at step 2: (its
    checkpoint directory, its final params)."""
    from orion_tpu_torch.training.checkpoint import Checkpointer
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    d = str(tmp_path_factory.mktemp("dp1_ckpt"))
    tr = Trainer(TrainConfig(model=ModelConfig(**SHARD), **CKPT_KW), device="cpu")
    ck = Checkpointer(d, save_every=2)
    for b in _batches(4):
        tr.step(torch.from_numpy(b).long())
        tr._save(ck, tr.step_count)
    return d, {n: p.detach().numpy().copy() for n, p in tr.params.items()}


@pytest.fixture(scope="module")
def runs(one_device):
    """{"jax": name -> (losses, final params tree), "port": name -> the
    ranks' results}. The ranks start from the JAX trainers' initial params
    and run while the JAX trainers step."""
    dp1, sp = _jax_trainer(SHARD, KW, JaxMeshConfig(dp=1)), \
        _jax_trainer(SP_MODEL, SP_KW, JaxMeshConfig(dp=2, sp=2))
    tree, sp_tree = jax.device_get(dp1.state.params), jax.device_get(sp.state.params)
    b16, b32 = _batches(2), _batches(2, 32, 4)
    port = {
        "dp2 fsdp2": dict(mesh=DP2F2, model=ModelConfig(**SHARD), tree=tree, batches=b16),
        "fsdp4": dict(mesh=FSDP4, model=ModelConfig(**SHARD), tree=tree, batches=b16),
        "dp2 sp2": dict(mesh=DP2SP2, model=ModelConfig(**SP_MODEL), tree=sp_tree, batches=b32,
                        kw=SP_KW),
        "restored": dict(mesh=DP2F2, model=ModelConfig(**SHARD), batches=_batches(4)[2:],
                         kw=CKPT_KW, ckpt=one_device[0], restore=2),
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(workers.run_ranks, 4, workers.mesh_runs,
                            {"mesh": DP2F2, "kw": KW, "runs": list(port.values())}, 240)
        jax_runs = {
            "dp1": _steps(dp1, b16),
            "dp2 fsdp2": _steps(_jax_trainer(SHARD, KW, JaxMeshConfig(dp=2, fsdp=2)), b16),
            "fsdp4": _steps(_jax_trainer(SHARD, KW, JaxMeshConfig(dp=1, fsdp=4)), b16),
            "dp2 sp2": _steps(sp, b32),
        }
        ranks = ranks.result()
    return {"jax": jax_runs, "port": {name: [r[i] for r in ranks] for i, name in enumerate(port)}}


def _check(ranks, losses, params_tree, model):
    ref = params_from_jax(params_tree, model)
    for r_losses, _, params, _ in ranks:
        np.testing.assert_allclose(r_losses, losses, **_TOL)
        for n, p in params.items():
            np.testing.assert_allclose(p, ref[n].numpy(), **_TOL, err_msg=n)
    for _, _, params, _ in ranks[1:]:  # the ranks agree bitwise
        for n, p in params.items():
            np.testing.assert_array_equal(p, ranks[0][2][n], err_msg=n)


@pytest.mark.parametrize("mesh", ["dp2 fsdp2", "fsdp4"])
@pytest.mark.parametrize("ref", ["dp1", "same mesh"])
def test_one_step_on_a_mesh_equals_the_jax_trainer(runs, mesh, ref):
    losses, params = runs["jax"]["dp1" if ref == "dp1" else mesh]
    _check(runs["port"][mesh], losses, params, ModelConfig(**SHARD))


def test_dp2_sp2_matches_the_jax_dp2_sp2_trainer(runs):
    losses, params = runs["jax"]["dp2 sp2"]
    _check(runs["port"]["dp2 sp2"], losses, params, ModelConfig(**SP_MODEL))


def test_checkpoint_restores_across_meshes(runs, one_device):
    """dp=1 to step 2, restored on dp 2 x fsdp 2 to step 4: the
    uninterrupted dp=1 run's params within 2e-5."""
    _, final = one_device
    for _, _, params, _ in runs["port"]["restored"]:
        for n, p in final.items():
            np.testing.assert_allclose(params[n], p, **_TOL, err_msg=n)


def test_train_cli_under_torchrun_matches_one_rank(tmp_path):
    """``torchrun --nproc_per_node 4 ... --distributed --dp 2 --fsdp 2
    --device cpu``: rank 0 alone prints the metrics, which equal a one-rank
    run's within 2e-5, and its checkpoint is the one-rank run's file, the
    same keys and params within 2e-5."""
    import ast
    import os
    import subprocess
    import sys

    common = ["-m", "orion_tpu_torch.train", "--device", "cpu", "--config", "tiny", "--steps",
              "2", "--seq-len", "32", "--batch-size", "4", "--set", "model.d_model=64",
              "--set", "model.n_heads=2", "--set", "model.n_layers=2",
              "--set", "model.dtype=float32"]
    env = dict(os.environ, PYTHONPATH=os.getcwd(), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    dp = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
         "--master_port", str(workers._free_port()), *common, "--distributed", "--dp", "2",
         "--fsdp", "2", "--ckpt-dir", str(tmp_path / "dp")],
        env=env, capture_output=True, text=True, timeout=240)
    one = subprocess.run([sys.executable, *common, "--ckpt-dir", str(tmp_path / "one")],
                         env=env, capture_output=True, text=True, timeout=240)
    assert dp.returncode == 0 and one.returncode == 0, dp.stderr[-3000:] + one.stderr[-3000:]
    assert dp.stderr.count("transport gloo") == 4
    printed = [[ast.literal_eval(line) for line in run.stdout.splitlines() if line.startswith("{")]
               for run in (dp, one)]
    assert len(printed[0]) == len(printed[1]) == 1
    assert printed[0][0] == pytest.approx(printed[1][0], rel=2e-5, abs=2e-5)
    files = [sorted(p.name for p in (tmp_path / d).glob("*.pt")) for d in ("dp", "one")]
    assert files[0] == files[1] == ["step-00000002.pt"]
    a, b = (torch.load(tmp_path / d / "step-00000002.pt", map_location="cpu")
            for d in ("dp", "one"))
    assert int(a["step"]) == int(b["step"]) == 2
    for key in ("mu", "nu"):
        assert {n: t.shape for n, t in a["opt"][key].items()} == \
            {n: t.shape for n, t in b["opt"][key].items()}
    assert a["params"].keys() == b["params"].keys()
    for n, p in b["params"].items():
        torch.testing.assert_close(a["params"][n], p, rtol=2e-5, atol=2e-5)
