"""Generate at tp 2 held against the JAX package, on two gloo CPU ranks.

- ``tiny`` (fp32, four heads, all linear) and ``tests/test_generate.py``'s
  linear + softmax + swa model: each rank's prefill logits equal the JAX
  model's within 1e-5, each rank's (S, z), KV cache and ring are its heads
  of the JAX state within 1e-5 (rank t holds heads [t H / 2, (t + 1) H /
  2)), and the greedy tokens equal the JAX ``generate``'s at single device
  and at ``MeshConfig(dp=2, tp=2)`` (``test_generate.py``'s
  ``test_sharded_generate_parity``); sampled tokens (temperature 0.8, top-k
  8) agree on both ranks and with a tp=1 port run (the port's counter keys
  draw other numbers than threefry, so a sampled token is held against the
  port, not against the JAX package).

The CLI under torchrun: ``tests/test_torch_tp_cli.py``.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
import torch_tp_workers as tp_workers
from orion_tpu.generate import SampleConfig as JaxSampleConfig
from orion_tpu.generate import generate as jax_generate
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig, make_mesh
from orion_tpu_torch.models.configs import ModelConfig, TINY
from orion_tpu_torch.parallel.mesh import MeshConfig

GEN = dict(name="gen_test", vocab_size=64, d_model=32, n_layers=3, n_heads=2,
           layer_types=("linear", "softmax", "swa"), window=4, max_seq_len=64, dtype="float32")
CASES = {"tiny": dataclasses.asdict(TINY), "linear softmax swa": GEN}
NEW = 9
SAMPLE = dict(temperature=0.8, top_k=8)


def _prompt(cfg):
    return np.array(jax.random.randint(jax.random.PRNGKey(3), (4, 7), 0, cfg["vocab_size"]))


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """The JAX model and its params from seed 0."""
    jm = JaxLM(JaxModelConfig(**dict(CASES[name], backend="xla")))
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))


@functools.lru_cache(maxsize=None)
def _jax(name):
    """(params, prefill logits and states, greedy tokens alone and at dp 2 x
    tp 2) of the JAX model."""
    jm, params = _jax_model(name)
    prompt = jnp.asarray(_prompt(CASES[name]))
    logits, states = jax.jit(functools.partial(jm.apply, method="prefill"))(params, prompt)
    greedy = jax_generate(jm, params, prompt, NEW, JaxSampleConfig(temperature=0.0))
    meshed = jax_generate(jm, params, prompt, NEW, JaxSampleConfig(temperature=0.0),
                          mesh=make_mesh(JaxMeshConfig(dp=2, tp=2)))
    return params, np.asarray(logits), jax.device_get(states), np.asarray(greedy), \
        np.asarray(meshed)


@pytest.fixture(scope="module")
def ranks():
    """The ranks' results; the JAX runs are made while the ranks run."""
    cases = [dict(model=ModelConfig(**cfg), tree=_jax_model(name)[1], prompt=_prompt(cfg),
                  new=NEW, sample=SAMPLE, seed=11) for name, cfg in CASES.items()]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        out = pool.submit(workers.run_ranks, 2, tp_workers.tp_generate_cases,
                          {"mesh": MeshConfig(dp=1, tp=2), "cases": cases})
        for name in CASES:
            _jax(name)
        return out.result()


@pytest.mark.parametrize("i,name", list(enumerate(CASES)))
def test_tp_prefill_states_and_greedy_tokens_match_jax(ranks, i, name):
    _, logits, states, greedy, meshed = _jax(name)
    np.testing.assert_array_equal(greedy, meshed)  # the reference's own contract
    heads = CASES[name]["n_heads"] // 2
    for rank in (0, 1):
        t, r_logits, r_states, r_greedy, _ = ranks[rank][i]
        assert t == rank
        np.testing.assert_allclose(r_logits, logits, rtol=1e-5, atol=1e-5)
        for st, ref in zip(r_states, states):
            assert set(st) == set(ref)
            for key, got in st.items():
                want = np.asarray(ref[key])[:, t * heads:(t + 1) * heads]
                assert got.shape == want.shape, (key, got.shape, want.shape)
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=key)
        np.testing.assert_array_equal(r_greedy, greedy)


@pytest.mark.parametrize("i,name", list(enumerate(CASES)))
def test_tp_sampled_tokens_agree_across_ranks_and_with_tp1(ranks, i, name):
    from orion_tpu_torch.convert import params_from_jax
    from orion_tpu_torch.generate import SampleConfig, generate
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = ModelConfig(**CASES[name])
    one = TransformerLM(cfg, device="cpu")
    one.load_state_dict(params_from_jax(_jax(name)[0], cfg), strict=True)
    want = generate(one, torch.from_numpy(_prompt(CASES[name])).long(), NEW,
                    SampleConfig(**SAMPLE), 11).numpy()
    for rank in (0, 1):
        np.testing.assert_array_equal(ranks[rank][i][4], want)
