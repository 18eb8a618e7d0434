"""The port's MoE TransformerLM held against the JAX package's, on the CPU:
the forward, the prefill and its (S, z) states, a decode step, greedy
generation, and ``moe_1b3_4e`` (shrunk in width) through the generate CLI.

A tiny MoE: ``TINY``'s widths (d_model 128, 4 heads of 32, fp32, vocab
256), 2 layers, block 1 routed over 4 experts (``moe_period`` 2), in four
variants: top-1 and top-2, each with capacity dispatch (factor 1.25 over
groups of 20 tokens, so the parallel forward drops tokens) and dropless.
Both models carry the same weights, a flax tree drawn with numpy from a seed
and loaded into the port by ``convert.py``; the JAX side runs its XLA forms
(the ragged_dot form for dropless), the port's side its plain forms (CPU
tensors: the ragged form). Tolerances (fp32): logits and states 1e-4, as
``tests/test_torch_model.py``; greedy tokens exactly.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.generate import SampleConfig as JaxSampleConfig
from orion_tpu.generate import generate as jax_generate
from orion_tpu.models.configs import TINY as JAX_TINY
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu_torch import generate as gen
from orion_tpu_torch.convert import expected_params, load_jax_params
from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.models.moe import MoEMLP
from orion_tpu_torch.models.transformer import TransformerLM, snapshot_decode_state

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)

_MOE = dict(n_experts=4, moe_period=2, moe_group_size=20)
VARIANTS = {
    "top1-capacity": dict(moe_top_k=1),
    "top2-capacity": dict(moe_top_k=2),
    "top1-dropless": dict(moe_top_k=1, moe_dropless=True),
    "top2-dropless": dict(moe_top_k=2, moe_dropless=True),
}


def cfgs(variant, backend="auto"):
    """(the port's config, the JAX package's, on its XLA forms)."""
    kw = {**_MOE, **VARIANTS[variant]}
    return (dataclasses.replace(TINY, backend=backend, **kw),
            dataclasses.replace(JAX_TINY, backend="xla", **kw))


@functools.lru_cache(maxsize=None)
def tree(seed=0):
    """A flax param tree for the tiny MoE drawn with numpy at the flax init
    scales (an expert stack [E, in, out] by its fan-in), norm scales around
    1 so that they matter. Every variant has the same tree."""
    cfg, _ = cfgs("top1-capacity")
    rng = np.random.default_rng(seed)
    out = {}
    for path, (_, shape, transpose) in expected_params(cfg).items():
        shape = shape[::-1] if transpose else shape  # flax kernels are [in, out]
        if path.endswith("scale"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            fan_in = shape[0] if transpose else shape[-2] if len(shape) == 3 else shape[1]
            arr = rng.standard_normal(shape) / np.sqrt(fan_in)
        node = out
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": out}


def model(variant, backend="auto"):
    return load_jax_params(TransformerLM(cfgs(variant, backend)[0], device="cpu"), tree())


def _tokens(seed, b=2, t=40):
    return np.random.default_rng(seed).integers(0, 256, (b, t), dtype=np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_tiny_moe_builds_the_jax_layout():
    m = model("top1-dropless")
    assert [type(b.mlp) for b in m.blocks][1] is MoEMLP
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items() if ".mlp." in k}
    assert shapes["blocks.1.mlp.router"] == (4, 128)
    assert shapes["blocks.1.mlp.experts_gate"] == shapes["blocks.1.mlp.experts_up"] == (4, 128, 384)
    assert shapes["blocks.1.mlp.experts_down"] == (4, 384, 128)
    assert "blocks.0.mlp.gate.weight" in shapes


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_prefill_and_decode_match_jax(variant):
    _, jcfg = cfgs(variant)
    jm, params = JaxLM(jcfg), tree()
    tokens = _tokens(1)
    nxt = np.array([3, 200], dtype=np.int32)

    @jax.jit
    def ref_fn(p, tokens, nxt):
        logits = jm.apply(p, tokens)
        pre, states = jm.apply(p, tokens, method="prefill")
        dec, states2 = jm.apply(p, nxt, states, jnp.int32(tokens.shape[1]), method="decode_step")
        return logits, pre, states, dec, states2

    ref, ref_pre, ref_states, ref_dec, ref_states2 = ref_fn(params, jnp.asarray(tokens),
                                                           jnp.asarray(nxt))
    m = model(variant)
    with torch.no_grad():
        out = m(torch.from_numpy(tokens).long())
        pre, states = m.prefill(torch.from_numpy(tokens).long())
        dec, states2 = m.decode_step(torch.from_numpy(nxt).long(), snapshot_decode_state(states),
                                     tokens.shape[1])
    for got, want in ((out, ref), (pre, ref_pre), (dec, ref_dec)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for got_states, want_states in ((states, ref_states), (states2, ref_states2)):
        for g, r in zip(got_states, want_states):
            assert set(g) == set(r) == {"s", "z"}
            for key in g:
                scale = max(1.0, float(np.abs(_np(r[key])).max()))
                np.testing.assert_allclose(_np(g[key]), _np(r[key]), rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_tokens_equal_jax_generate(variant):
    """Both serve a capacity model at capacity factor E / k (no drops in the
    prefill, as in decode)."""
    _, jcfg = cfgs(variant)
    prompt = _tokens(3, t=24)
    ref = jax_generate(JaxLM(jcfg), tree(), jnp.asarray(prompt), 12,
                       JaxSampleConfig(temperature=0.0), jax.random.PRNGKey(0))
    m = model(variant)
    out = gen.generate(m, torch.from_numpy(prompt), 12, gen.SampleConfig(temperature=0.0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the serving capacity applied for the call only
    assert all(b.mlp.capacity_factor == 1.25 for b in m.blocks if isinstance(b.mlp, MoEMLP))


def test_capacity_serving_keeps_every_token():
    """At the training capacity the parallel forward drops tokens; under
    no_drop_capacity the prefill of a prompt equals prefill + decode steps
    token by token, as the dropless form always does."""
    m = model("top1-capacity")
    tokens = torch.from_numpy(_tokens(5, t=30)).long()
    with torch.no_grad(), gen.no_drop_capacity(m):
        full, _ = m.prefill(tokens)
        logits, states = m.prefill_last(tokens[:, :10])
        steps = [logits]
        for i in range(10, 29):
            logits, states = m.decode_step(tokens[:, i], states, i)
            steps.append(logits)
    torch.testing.assert_close(torch.stack(steps, 1), full[:, 9:29], rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        dropping, _ = m.prefill(tokens)
    assert float((dropping - full).abs().max()) > 1e-3  # training capacity drops here


_SHRINK = {"d_model": 128, "n_heads": 4, "max_seq_len": 256, "moe_dropless": "true"}


def test_moe_generate_cli_runs_on_the_cpu():
    """``moe_1b3_4e`` shrunk in width (its 24 layers and 6 routed blocks kept)."""
    shrink = [a for k, v in _SHRINK.items() for a in ("--set", f"{k}={v}")]
    cmd = [sys.executable, "-m", "orion_tpu_torch.generate", "--config", "moe_1b3_4e", *shrink,
           "--device", "cpu", "--temperature", "0", "--max-new-tokens", "8"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("Hello")
