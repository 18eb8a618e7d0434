"""The port's Trainer with tp on the models beyond linear + softmax, held
against the JAX package's Trainer on four gloo CPU ranks:

- ``tests/test_torch_sp_trainer.py``'s model (linear, softmax, swa,
  ``sequence_parallel``) at sp 2 x tp 2: the sp bodies on this rank's heads,
  against the JAX Trainer at ``MeshConfig(dp=1, tp=2, sp=2)`` (the
  reference's ``test_trainer_sequence_parallel_parity`` runs tp 2 x sp 4);
- ``tests/test_moe.py``'s tiny MoE (4 experts every second block, top-1,
  capacity 4) at dp 2 x tp 2, in its capacity and dropless forms: the
  expert stacks' hidden dimension split over tp, the router whole, the
  load-balance statistics over the data group; against the JAX Trainer at
  ``MeshConfig(dp=1)``;
- ``feature_map="learnable"`` with an untied head at dp 2 x tp 2 against
  the JAX Trainer at ``MeshConfig(dp=1)``: ``phi_proj`` is held whole on
  every tp rank and read by its heads only, so this case fails unless its
  gradient is summed over the tp group; the untied head is held whole.

Two steps from the JAX Trainer's params, 2e-5 on the loss and every param;
every rank ends with the same params (bitwise). One spawn runs every case
(``tests/torch_sp_workers.py``'s ``mesh_runs``).
"""

import concurrent.futures

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
from orion_tpu_torch.parallel.mesh import MeshConfig

_TOL = dict(rtol=2e-5, atol=2e-5)
KW = dict(steps=2, batch_size=8, seq_len=16, lr=1e-3, warmup_steps=1, log_every=100)
SP_MODEL = dict(name="sp_test", vocab_size=64, d_model=32, n_layers=3, n_heads=2,
                max_seq_len=64, dtype="float32", layer_types=("linear", "softmax", "swa"),
                window=6, sequence_parallel=True, chunk=8)
SP_KW = dict(steps=2, batch_size=4, seq_len=32, lr=1e-3, warmup_steps=1, log_every=100)
MOE = dict(name="moe_test", vocab_size=64, d_model=32, n_layers=4, n_heads=2, max_seq_len=64,
           dtype="float32", n_experts=4, moe_period=2, moe_top_k=1, moe_capacity_factor=4.0)
LEARNABLE = dict(name="learnable_test", vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                 max_seq_len=64, dtype="float32", feature_map="learnable", tie_embeddings=False)
DP2T2 = MeshConfig(dp=2, tp=2)
CASES = {
    "sp2 tp2": (SP_MODEL, SP_KW, MeshConfig(dp=1, tp=2, sp=2), JaxMeshConfig(dp=1, tp=2, sp=2)),
    "moe capacity": (MOE, KW, DP2T2, JaxMeshConfig(dp=1)),
    "moe dropless": (dict(MOE, moe_dropless=True), KW, DP2T2, JaxMeshConfig(dp=1)),
    "learnable untied": (LEARNABLE, KW, DP2T2, JaxMeshConfig(dp=1)),
}


def _batches(kw):
    ds = SyntheticDataset(64, kw["seq_len"])
    return [np.asarray(ds.batch(0, i, kw["batch_size"])) for i in range(kw["steps"])]


@pytest.fixture(scope="module")
def runs():
    trainers = {name: JaxTrainer(JaxTrainConfig(model=JaxModelConfig(backend="xla", **model),
                                                mesh=jmesh, **kw))
                for name, (model, kw, _, jmesh) in CASES.items()}
    port = [dict(mesh=mesh, model=ModelConfig(**model), kw=kw, batches=_batches(kw),
                 tree=jax.device_get(trainers[name].state.params))
            for name, (model, kw, mesh, _) in CASES.items()]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(workers.run_ranks, 4, workers.mesh_runs,
                            {"mesh": DP2T2, "kw": KW, "runs": port}, 240)
        ref = {}
        for name, tr in trainers.items():
            losses = [float(tr.step(jnp.asarray(b))["loss"]) for b in _batches(CASES[name][1])]
            ref[name] = (losses, jax.device_get(tr.state.params))
        ranks = ranks.result()
    return ref, {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_two_tp_steps_equal_the_jax_trainer(runs, name):
    (losses, tree), ranks = runs[0][name], runs[1][name]
    ref = params_from_jax(tree, ModelConfig(**CASES[name][0]))
    for r_losses, _, params, _ in ranks:
        np.testing.assert_allclose(r_losses, losses, **_TOL)
        for n, p in params.items():
            np.testing.assert_allclose(p, ref[n].numpy(), **_TOL, err_msg=n)
    for _, _, params, _ in ranks[1:]:  # the ranks agree bitwise
        for n, p in params.items():
            np.testing.assert_array_equal(p, ranks[0][2][n], err_msg=n)
