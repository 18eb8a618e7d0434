"""A MoE model through the port's pipeline on four gloo CPU ranks (pp 2 x dp
2) held against the JAX package's Trainer, on the CPU: the two microbatch
forms.

``tests/test_moe.py``'s MoE (4 layers, 4 experts in every other block, top
1, capacity factor 4) for two steps from the JAX Trainer's params:

- at one microbatch (``pp_microbatches=1``): the aux sees every row of the
  batch, so the pp step equals the JAX Trainer's single-device step
  (``test_pp_moe_parity_single_microbatch``; 3e-5 on the loss, the grad
  norm and every param);
- at two microbatches, partial-manual (``pp_full_manual=False``: microbatch
  m is every data rank's share of the global microbatch m, the load-balance
  statistics global over the data group) against the JAX Trainer at the same
  mesh with ``pp_full_manual=False``, and full-manual (each data rank's own
  rows and statistics, the aux averaged over the data ranks) against
  ``pp_full_manual=True``: 3e-5 each. The two forms' losses differ (the
  statistics of other rows), as the JAX package's do.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_pp_workers as pp_workers
import torch_sp_workers as workers
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from orion_tpu.parallel.pipeline_lm import unstack_lm_params
from orion_tpu.training.data import SyntheticDataset
from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
from orion_tpu.training.trainer import Trainer as JaxTrainer
from orion_tpu_torch.convert import params_from_jax
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel.mesh import MeshConfig

_TOL = dict(rtol=3e-5, atol=3e-5)
MOE = dict(name="moe_test", vocab_size=64, d_model=32, n_layers=4, n_heads=2, max_seq_len=64,
           dtype="float32", n_experts=4, moe_period=2, moe_top_k=1, moe_capacity_factor=4.0)
KW = dict(steps=2, batch_size=8, seq_len=16, lr=1e-3, warmup_steps=1, log_every=100)
FORMS = {"one microbatch": dict(pp_microbatches=1),
         "partial-manual": dict(pp_microbatches=2, pp_full_manual=False),
         "full-manual": dict(pp_microbatches=2, pp_full_manual=True)}


def _batches():
    ds = SyntheticDataset(64, 16)
    return [np.asarray(ds.batch(0, i, 8)) for i in range(2)]


def _jax(mesh, **kw):
    tr = JaxTrainer(JaxTrainConfig(model=JaxModelConfig(backend="xla", **MOE), mesh=mesh,
                                   **KW, **kw))
    ms = [tr.step(jnp.asarray(b)) for b in _batches()]
    params = jax.device_get(tr.state.params)
    if "blocks_stacked" in params["params"]:
        params = unstack_lm_params(tr.model, params)
    return [float(m["loss"]) for m in ms], [float(m["grad_norm"]) for m in ms], params


@pytest.fixture(scope="module")
def runs():
    dp1 = JaxTrainer(JaxTrainConfig(model=JaxModelConfig(backend="xla", **MOE),
                                    mesh=JaxMeshConfig(dp=1), **KW))
    tree = jax.device_get(dp1.state.params)
    port = [dict(mesh=MeshConfig(dp=2, pp=2), model=ModelConfig(**MOE), tree=tree,
                 batches=_batches(), kw=dict(KW, **kw)) for kw in FORMS.values()]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(workers.run_ranks, 4, pp_workers.trainer_runs,
                            {"mesh": MeshConfig(dp=2, pp=2), "kw": KW, "runs": port}, 240)
        ms = [dp1.step(jnp.asarray(b)) for b in _batches()]
        ref = {"one microbatch": ([float(m["loss"]) for m in ms],
                                  [float(m["grad_norm"]) for m in ms],
                                  jax.device_get(dp1.state.params))}
        for form in ("partial-manual", "full-manual"):
            ref[form] = _jax(JaxMeshConfig(dp=2, pp=2), **FORMS[form])
        ranks = spawn.result()
    return ref, {form: [r[i] for r in ranks] for i, form in enumerate(FORMS)}


@pytest.mark.parametrize("form", list(FORMS))
def test_moe_under_pp_equals_the_jax_trainer(runs, form):
    ref, port = runs
    losses, norms, tree = ref[form]
    want = params_from_jax(tree, ModelConfig(**MOE))
    for r_losses, r_norms, params, _, extra in port[form]:
        assert extra["n_micro"] == FORMS[form]["pp_microbatches"]
        assert extra["full_manual"] == (form == "full-manual")
        np.testing.assert_allclose(r_losses, losses, **_TOL)
        np.testing.assert_allclose(r_norms, norms, **_TOL)
        for n, p in params.items():
            np.testing.assert_allclose(p, want[n].numpy(), **_TOL, err_msg=n)


def test_the_two_forms_differ_for_moe(runs):
    _, port = runs
    a, b = (port[f][0][0] for f in ("partial-manual", "full-manual"))
    assert a[0] != b[0]
