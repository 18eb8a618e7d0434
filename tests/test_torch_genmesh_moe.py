"""MoE layers in ``generate`` on a 4-rank mesh (the expert stacks, bf16 and
``_q``, in decode), held against the JAX package's quantized ``generate``
on the same mesh, on gloo CPU ranks (one spawn shared by the cases;
``tests/torch_genmesh_common.py``):

- a dropless MoE at int8 on dp 2 x fsdp 2 and a capacity MoE at int4 on
  fsdp 2 x tp 2, both from the JAX MoE model's params: every rank's greedy
  tokens equal the JAX ``generate(..., mesh=..., quant=...)``'s.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_genmesh_common as common
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu_torch.models.configs import ModelConfig

# (label, the expert form, the mesh, quant)
MOE = (("dropless MoE int8 at dp2 x fsdp2", dict(moe_dropless=True), dict(dp=2, fsdp=2), "int8"),
       ("capacity MoE int4 at fsdp2 x tp2", {}, dict(fsdp=2, tp=2), "int4"))


def _fields(form):
    return dict(common.GEN, layer_types=("linear", "swa"), n_layers=2, n_experts=4,
                moe_period=2, **form)


@functools.lru_cache(maxsize=None)
def _jax_moe(i):
    """The JAX MoE model of ``MOE[i]`` and its params from seed 0."""
    jm = JaxLM(JaxModelConfig(**dict(_fields(MOE[i][1]), backend="xla")))
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))


def _jax_tokens(i):
    """The JAX quantized greedy tokens of ``MOE[i]``'s model on its mesh."""
    jm, params = _jax_moe(i)
    _, _, sizes, quant = MOE[i]
    return np.asarray(common.jax_generate(
        jm, params, jnp.asarray(common.prompt()), common.NEW,
        common.JaxSampleConfig(temperature=0.0), mesh=common.jax_mesh(sizes), quant=quant))


@pytest.fixture(scope="module")
def runs():
    """[(each rank's result, the JAX tokens at its mesh)] in ``MOE``'s order."""
    cases = [dict(model=ModelConfig(**_fields(form)), tree=_jax_moe(i)[1],
                  prompt=common.prompt(), new=common.NEW,
                  mesh=common.MeshConfig(**{"dp": 1, **sizes}), quant=q)
             for i, (_, form, sizes, q) in enumerate(MOE)]

    def jax_work():  # the two compiles overlap
        with concurrent.futures.ThreadPoolExecutor(len(MOE)) as pool:
            return list(pool.map(_jax_tokens, range(len(MOE))))

    ranks, meshed = common.run_with_jax(4, cases, jax_work)
    return list(zip(ranks, meshed))


@pytest.mark.parametrize("i,label", list(enumerate(m[0] for m in MOE)))
def test_moe_on_a_mesh_matches_jax_on_the_mesh(runs, i, label):
    ranks, meshed = runs[i]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["greedy"], meshed, err_msg=f"{label} rank {r}")
