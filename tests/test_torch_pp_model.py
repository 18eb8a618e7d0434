"""The port's pipelined ``TransformerLM`` (``parallel/pipeline_lm.py``) on
two gloo CPU ranks at pp 2 held against the JAX package's ``pp_lm_logits``
/ ``pp_lm_loss`` on the same params and tokens, on the CPU.

One spawn (``tests/torch_pp_workers.py``'s ``lm_cases``) runs each case,
each stage's model loading its blocks of the JAX params:

- ``tests/test_pipeline.py::test_pp_transformer_lm_parity``' all-linear LM
  (4 layers, d 32) at n_micro 4: the last stage's logits (2e-5, the JAX
  test's), the loss and every parameter's gradient (5e-5, the JAX test's;
  the leaves every stage holds summed over the stages);
- ``test_pp_hybrid_model_parity``' hybrid, (swa, swa, linear) x 2 with
  window 4, stacked by groups of 3 (one group a stage): logits (2e-5),
  loss and gradients (5e-5);
- a MoE (4 experts in every other block, dropless) at n_micro 2: logits,
  the aux summed over the stages and averaged over the microbatches, the
  loss with it and its gradients, against ``return_aux`` (5e-5);
- dropout 0.5 (``test_pp_dropout_rng_plumbing``): the same seed gives the
  same loss, another seed another, and both differ from the loss without
  dropout (the masks are the pipeline's own: JAX's threefry and the port's
  generators draw different ones).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_pp_workers as pp_workers
import torch_sp_workers as workers
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.parallel.pipeline_lm import pp_lm_logits, pp_lm_loss
from orion_tpu_torch.convert import params_from_jax
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel.mesh import MeshConfig

BASE = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=2, max_seq_len=32, dtype="float32")
CASES = {
    "linear": (dict(BASE, name="pp_test", remat=False), (8, 16), 4),
    "hybrid": (dict(BASE, name="pp_hybrid", n_layers=6, layer_types=("swa", "swa", "linear") * 2,
                    window=4, max_seq_len=64), (4, 16), 4),
    "moe": (dict(BASE, name="pp_moe", n_experts=4, moe_period=2, moe_dropless=True), (8, 16), 2),
}
DROP = dict(BASE, name="pp_drop", max_seq_len=64, dropout=0.5)


def _jax(name):
    model_kw, shape, n_micro = CASES[name]
    model = JaxLM(JaxModelConfig(backend="xla", **model_kw))
    tokens = jax.random.randint(jax.random.PRNGKey(0), shape, 0, 64)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), tokens)
    return model, jax.device_get(params), tokens, n_micro


def _reference(model, params, tokens, n_micro):
    """The JAX package's pp 2 logits (and aux), loss and gradients."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("pp",))
    batch = jnp.concatenate([tokens, tokens[:, :1]], axis=1)
    moe = model.cfg.n_experts > 0
    out = jax.jit(lambda p, t: pp_lm_logits(model, p, t, mesh, n_micro=n_micro,
                                            return_aux=moe))(params, tokens)
    logits, aux = out if moe else (out, 0.0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: pp_lm_loss(model, p, b, mesh, n_micro=n_micro)))(params, batch)
    return logits, aux, loss, grads


@pytest.fixture(scope="module")
def runs():
    cases, jax_in = [], {}
    for name in CASES:
        model, params, tokens, n_micro = jax_in[name] = _jax(name)
        cases.append({"mesh": MeshConfig(dp=1, pp=2), "model": ModelConfig(**CASES[name][0]),
                      "tree": params, "tokens": np.asarray(tokens), "n_micro": n_micro})
    dmodel = JaxLM(JaxModelConfig(backend="xla", **DROP))
    dtok = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (4, 16), 0, 64))
    cases.append({"mesh": MeshConfig(dp=1, pp=2), "model": ModelConfig(**DROP),
                  "tree": jax.device_get(jax.jit(dmodel.init)(jax.random.PRNGKey(0),
                                                              jnp.asarray(dtok))),
                  "tokens": dtok, "n_micro": 2, "dropout_seeds": [1, 1, 2]})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(workers.run_ranks, 2, pp_workers.lm_cases,
                            {"mesh": MeshConfig(dp=1, pp=2), "cases": cases})
        ref = {}
        for name, (model, params, tokens, n_micro) in jax_in.items():
            logits, aux, loss, grads = _reference(model, params, tokens, n_micro)
            cfg = ModelConfig(**CASES[name][0])
            ref[name] = {"logits": np.asarray(logits), "aux": float(aux), "loss": float(loss),
                         "grads": {k: t.numpy() for k, t in
                                   params_from_jax(jax.device_get(grads), cfg).items()}}
        ranks = spawn.result()
    return ref, {name: [r[i] for r in ranks] for i, name in enumerate(list(CASES) + ["dropout"])}


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_jax_pp_lm_logits(runs, name):
    ref, port = runs
    first, last = port[name]
    assert first["logits"] is None  # the logits live on the last stage
    np.testing.assert_allclose(last["logits"], ref[name]["logits"], atol=2e-5, rtol=2e-5)
    for r in port[name]:  # the aux, summed over the stages, on every stage
        np.testing.assert_allclose(r["aux"], ref[name]["aux"], atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradients_match_jax_pp_lm_loss(runs, name):
    ref, port = runs
    seen = set()
    for r in port[name]:
        np.testing.assert_allclose(r["loss"], ref[name]["loss"], rtol=1e-5)
        for k, g in r["grads"].items():
            seen.add(k)
            np.testing.assert_allclose(g, ref[name]["grads"][k], atol=5e-5, rtol=5e-5, err_msg=k)
    assert seen == set(ref[name]["grads"])
    # each stage held its own blocks and every stage the rest
    blocks = [{k.split(".")[1] for k in r["grads"] if k.startswith("blocks.")} for r in port[name]]
    assert not blocks[0] & blocks[1]


def test_dropout_plumbing(runs):
    _, port = runs
    for r in port["dropout"]:
        l1, l1b, l2 = r["drops"]
        assert l1 == l1b and l1 != l2 and l1 != r["loss"]
        assert np.isfinite([l1, l2]).all()
