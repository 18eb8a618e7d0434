"""Quantized serving in the port held against the JAX package's, on the CPU.

Four tiny models -- ``TINY`` (linear layers, the tied head), a tiny hybrid
(a swa layer of window 16 and a linear one) and a tiny MoE (block 1 routed
top-1 over 4 experts) in its capacity and its dropless form -- each at
``"int8"`` and ``"int4"``. The fp32 weights are a flax tree drawn with numpy
from a seed. The port quantizes them (``generate.quantize_for_decode``) and
runs its plain forms (CPU tensors: the int4 layers' split half-dots, the
ragged MoE form); the JAX package's quantized model runs its XLA forms on
the same quantized weights, and its own ``quantize_for_decode`` of the fp32
tree is held against the port's quantization separately. Tolerances (fp32):
logits 1e-4, as the port's other parity tests; greedy tokens exactly; the
quantized tensors as ``test_quantizing_in_the_port_equals_converting_the_jax_tree``
states.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.generate import quantize_for_decode as jax_quantize_for_decode
from orion_tpu.models.configs import TINY as JAX_TINY
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu_torch import generate as gen
from orion_tpu_torch import quant as tq
from orion_tpu_torch.convert import expected_params, load_jax_params, params_from_jax
from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.models.transformer import TransformerLM

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)

_MOE = dict(n_experts=4, moe_period=2, moe_group_size=20)
MODELS = {
    "tiny": {},
    "hybrid": dict(layer_types=("swa", "linear"), window=16),
    "moe-capacity": _MOE,
    "moe-dropless": dict(_MOE, moe_dropless=True),
}
CASES = [(m, q) for m in MODELS for q in ("int8", "int4")]


def cfgs(name):
    """(the port's config, the JAX package's, on its XLA forms)."""
    return (dataclasses.replace(TINY, **MODELS[name]),
            dataclasses.replace(JAX_TINY, backend="xla", **MODELS[name]))


@functools.lru_cache(maxsize=None)
def tree(name):
    """A flax param tree drawn with numpy at the flax init scales, norm
    scales around 1."""
    rng = np.random.default_rng(7)
    out = {}
    for path, (_, shape, transpose) in expected_params(cfgs(name)[0]).items():
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


@functools.lru_cache(maxsize=None)
def jax_quantized(name, quant):
    """The JAX package's quantize_for_decode of the tree: (its quantized
    model, the quantized param tree as numpy)."""
    qm, qp = jax_quantize_for_decode(JaxLM(cfgs(name)[1]), jax.tree.map(jnp.asarray, tree(name)),
                                     mode=quant)
    return qm, jax.device_get(qp)


def flax_tree(state, cfg, quant):
    """A port state_dict -> the flax param tree of the same model (what
    convert.py reads, written back)."""
    out = {}
    for path, (key, _, transpose) in expected_params(cfg, quant).items():
        arr = state[key].numpy()
        node = out
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr.T if transpose else arr
    return {"params": out}


def _tokens(seed, b=2, t=24):
    return np.random.default_rng(seed).integers(0, 256, (b, t), dtype=np.int32)


@pytest.mark.parametrize("name,quant", CASES)
def test_quantized_logits_and_greedy_tokens_match_jax(name, quant):
    """The port's quantized model against the JAX package's quantized model
    (``TransformerLM(cfg, quant=...)``) on the same quantized weights, both
    served at the no-drop capacity (E / k) as their ``generate`` serves a
    capacity MoE: the prefill's logits, then 7 greedy decode steps' tokens
    and logits, the JAX side in one jitted scan."""
    cfg, jcfg = cfgs(name)
    if jcfg.n_experts and not jcfg.moe_dropless:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=jcfg.n_experts / jcfg.moe_top_k)
    fp = load_jax_params(TransformerLM(cfg, device="cpu"), tree(name))
    m = gen.quantize_for_decode(fp, quant)
    qm = JaxLM(jcfg, quant=quant)
    qp = jax.tree.map(jnp.asarray, flax_tree(m.state_dict(), cfg, quant))
    prompt = _tokens(3, t=16)

    @jax.jit
    def ref_fn(p, prompt):
        logits, states = qm.apply(p, prompt, method="prefill_last")

        def step(carry, i):
            lg, st = carry
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            lg, st = qm.apply(p, tok, st, prompt.shape[1] + i, method="decode_step")
            return (lg, st), (tok, lg)

        _, (toks, dec) = jax.lax.scan(step, (logits, states), jnp.arange(7))
        return logits, toks.T, dec

    ref_pre, ref_toks, ref_dec = (np.asarray(x) for x in ref_fn(qp, jnp.asarray(prompt)))
    toks = gen.generate(m, torch.from_numpy(prompt), 8, gen.SampleConfig(temperature=0.0),
                        quant=quant)
    np.testing.assert_array_equal(toks.numpy()[:, :7], ref_toks)
    with torch.inference_mode(), gen.no_drop_capacity(m):
        pre, states = m.prefill_last(torch.from_numpy(prompt).long())
        dec = []
        for i in range(7):
            lg, states = m.decode_step(toks[:, i], states, prompt.shape[1] + i)
            dec.append(lg)
    np.testing.assert_allclose(pre.numpy(), ref_pre, **TOL)
    np.testing.assert_allclose(torch.stack(dec).numpy(), ref_dec, **TOL)
    assert int(toks[0, 7]) == int(np.argmax(ref_dec[-1, 0]))  # the last token, from the last logits


def _ratios(key, w, s):
    """w / s as the quantizer rounds it, for a quantized tensor's key: each
    value's distance from the nearest .5 tie says where a one-step rounding
    difference could come from."""
    if key.endswith("_p4"):
        return w.t() / s
    return w / (s[:, None, :] if w.dim() == 3 else s[:, None])


@pytest.mark.parametrize("name,quant", [("tiny", "int4"), ("moe-dropless", "int8")])
def test_quantizing_in_the_port_equals_converting_the_jax_tree(name, quant):
    """The port's quantize_for_decode of the fp32 weights against what
    convert.py makes of the JAX package's quantized tree. The JAX package
    quantizes under jit, where XLA turns the division by 127 (or 7) into a
    product with its reciprocal: a scale may differ by one fp32 ulp, and
    then an integer by one step where w / s lies at a .5 tie. So: scales
    within 1 ulp, integers equal except at ties, at most one step there
    (counted: none at these weights), every other tensor bitwise."""
    cfg = cfgs(name)[0]
    fp = load_jax_params(TransformerLM(cfg, device="cpu"), tree(name))
    src = fp.state_dict()
    ours = gen.quantize_for_decode(fp, quant).state_dict()
    theirs = params_from_jax(jax_quantized(name, quant)[1], cfg, quant)
    assert set(ours) == set(theirs)
    tie_steps = 0
    for key, t in theirs.items():
        o = ours[key]
        assert o.dtype == t.dtype and o.shape == t.shape, key
        if key.endswith("_s"):
            np.testing.assert_array_max_ulp(o.numpy(), t.numpy(), maxulp=1)
        elif key.endswith(("_q", "_p4")):
            base = key.rsplit("_", 1)[0]
            if key.endswith("_p4"):
                o, t = (tq._unpack_nibbles(x, 2 * x.shape[0]) for x in (o, t))
            diff = (o.int() - t.int()).abs()
            assert int(diff.max()) <= 1, key
            if int(diff.sum()):
                frac = _ratios(key, src[base], ours[base + "_s"]).abs().frac()
                assert bool(((frac[diff.bool()] - 0.5).abs()
                             < 1e-4).all()), key
                tie_steps += int(diff.sum())
        else:
            assert torch.equal(o, t), key
    assert tie_steps == 0


def test_serving_a_prequantized_model_is_bitwise_generate_quant():
    cfg = cfgs("tiny")[0]
    fp = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    prompt = torch.from_numpy(_tokens(5, t=12)).long()
    greedy = gen.SampleConfig(temperature=0.0)
    for quant in ("int8", "int4"):
        once = gen.quantize_for_decode(fp, quant)
        assert torch.equal(gen.generate(once, prompt, 6, greedy, quant=quant),
                           gen.generate(fp, prompt, 6, greedy, quant=quant))
        assert gen.cast_params_for_inference(once) is once  # the fp32 scales stay fp32
        assert all(v.dtype in (torch.int8, torch.float32) for v in once.state_dict().values())
    with pytest.raises(ValueError, match="already quantized"):
        gen.generate(gen.quantize_for_decode(fp, "int8"), prompt, 2, greedy, quant="int4")
    with pytest.raises(ValueError, match="full-precision"):
        gen.quantize_for_decode(gen.quantize_for_decode(fp, "int8"), "int4")
    with pytest.raises(ValueError, match="quant must be"):
        TransformerLM(cfg, device="cpu", quant="int2")


def test_generate_cli_runs_int4_on_the_cpu(capsys):
    assert gen.main(["--config", "tiny", "--device", "cpu", "--quant", "int4", "--temperature", "0",
                     "--max-new-tokens", "8"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Hello") and len(out.strip()) >= len("Hello")
