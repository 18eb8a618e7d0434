"""The port's Trainer on four gloo CPU ranks with tp -- dp 2 x tp 2 and
fsdp 2 x tp 2 -- held against the JAX package's Trainer, and checkpoints
across tp meshes, on the CPU.

One spawn (``tests/torch_sp_workers.py``'s ``mesh_runs``) runs every case,
each on its own mesh of the one process group:

- ``tests/test_sharding.py::test_trainer_parity_across_meshes``'
  configuration (linear + softmax, fp32) at dp 2 x tp 2 and at fsdp 2 x tp 2
  (its ``f4t2`` mesh cut to four ranks), two steps from the JAX Trainer's
  params, against the JAX Trainer at ``MeshConfig(dp=1)`` and at the same
  mesh on the conftest's virtual CPU devices (2e-5 on the loss and every
  param); every rank ends with the same params (bitwise);
- ``tests/test_training.py::test_checkpoint_restores_across_meshes``'
  counterpart: a tp=1 run in this process saves at step 2 and runs to step
  4; an fsdp 2 x tp 2 trainer restores step 2 and runs to step 4, equal to
  the uninterrupted run within 2e-5;
- a dp 2 x tp 2 run from the seed saving at step 2: its file is the one the
  tp=1 run wrote (the same keys and shapes, params and AdamW moments within
  2e-5).
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
CKPT_KW = dict(KW, steps=4)
DP2T2, F2T2 = MeshConfig(dp=2, tp=2), MeshConfig(dp=1, fsdp=2, tp=2)


def _batches(n, seq_len=16, b=8):
    ds = SyntheticDataset(64, seq_len)
    return [np.asarray(ds.batch(0, i, b)) for i in range(n)]


def _jax_trainer(mesh):
    return JaxTrainer(JaxTrainConfig(model=JaxModelConfig(backend="xla", **SHARD), mesh=mesh,
                                     **KW))


def _steps(tr, batches):
    losses = [float(tr.step(jnp.asarray(b))["loss"]) for b in batches]
    return losses, jax.device_get(tr.state.params)


def check(ranks, losses, params_tree):
    """Each rank's losses and whole params against the JAX run's within
    2e-5, and the ranks' params bitwise one another's."""
    ref = params_from_jax(params_tree, ModelConfig(**SHARD))
    for r_losses, _, params, _ in ranks:
        np.testing.assert_allclose(r_losses, losses, **_TOL)
        for n, p in params.items():
            np.testing.assert_allclose(p, ref[n].numpy(), **_TOL, err_msg=n)
    for _, _, params, _ in ranks[1:]:
        for n, p in params.items():
            np.testing.assert_array_equal(p, ranks[0][2][n], err_msg=n)


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """The uninterrupted tp=1 run from the seed, saving at step 2: (its
    checkpoint directory, its final params)."""
    from orion_tpu_torch.training.checkpoint import Checkpointer
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    d = str(tmp_path_factory.mktemp("tp1_ckpt"))
    tr = Trainer(TrainConfig(model=ModelConfig(**SHARD), **CKPT_KW), device="cpu")
    ck = Checkpointer(d, save_every=2)
    for b in _batches(4):
        tr.step(torch.from_numpy(b).long())
        tr._save(ck, tr.step_count)
    return d, {n: p.detach().numpy().copy() for n, p in tr.params.items()}


@pytest.fixture(scope="module")
def runs(one_device, tmp_path_factory):
    dp1 = _jax_trainer(JaxMeshConfig(dp=1))
    tree = jax.device_get(dp1.state.params)
    b16 = _batches(2)
    saved = str(tmp_path_factory.mktemp("tp2_ckpt"))
    port = {
        "dp2 tp2": dict(mesh=DP2T2, model=ModelConfig(**SHARD), tree=tree, batches=b16),
        "fsdp2 tp2": dict(mesh=F2T2, model=ModelConfig(**SHARD), tree=tree, batches=b16),
        "saved": dict(mesh=DP2T2, model=ModelConfig(**SHARD), batches=_batches(4)[:2],
                      kw=CKPT_KW, ckpt=saved, save_every=2),
        "restored": dict(mesh=F2T2, model=ModelConfig(**SHARD), batches=_batches(4)[2:],
                         kw=CKPT_KW, ckpt=one_device[0], restore=2),
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(workers.run_ranks, 4, workers.mesh_runs,
                            {"mesh": DP2T2, "kw": KW, "runs": list(port.values())}, 240)
        jax_runs = {"dp1": _steps(dp1, b16),
                    "dp2 tp2": _steps(_jax_trainer(JaxMeshConfig(dp=2, tp=2)), b16),
                    "fsdp2 tp2": _steps(_jax_trainer(JaxMeshConfig(dp=1, fsdp=2, tp=2)), b16)}
        ranks = ranks.result()
    return {"jax": jax_runs, "saved": saved,
            "port": {name: [r[i] for r in ranks] for i, name in enumerate(port)}}


@pytest.mark.parametrize("mesh", ["dp2 tp2", "fsdp2 tp2"])
@pytest.mark.parametrize("ref", ["dp1", "same mesh"])
def test_two_steps_on_a_tp_mesh_equal_the_jax_trainer(runs, mesh, ref):
    check(runs["port"][mesh], *runs["jax"]["dp1" if ref == "dp1" else mesh])


def test_checkpoint_restores_across_tp_meshes(runs, one_device):
    """tp=1 to step 2, restored on fsdp 2 x tp 2 to step 4: the
    uninterrupted tp=1 run's params within 2e-5."""
    _, final = one_device
    for _, _, params, _ in runs["port"]["restored"]:
        for n, p in final.items():
            np.testing.assert_allclose(params[n], p, **_TOL, err_msg=n)


def test_a_tp_run_writes_the_tp1_file(runs, one_device):
    """dp 2 x tp 2's step-2 file against the tp=1 run's: the same keys and
    shapes, the params and AdamW moments within 2e-5."""
    a, b = (torch.load(f"{d}/step-00000002.pt", map_location="cpu")
            for d in (runs["saved"], one_device[0]))
    assert int(a["step"]) == int(b["step"]) == 2
    assert a["params"].keys() == b["params"].keys()
    for n, p in b["params"].items():
        torch.testing.assert_close(a["params"][n], p, rtol=2e-5, atol=2e-5)
    for key in ("mu", "nu"):
        assert {n: t.shape for n, t in a["opt"][key].items()} == \
            {n: t.shape for n, t in b["opt"][key].items()}
        for n, t in b["opt"][key].items():
            torch.testing.assert_close(a["opt"][key][n], t, rtol=2e-5, atol=2e-5)
