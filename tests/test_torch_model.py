"""The port's TransformerLM held against the JAX package's on the CPU.

Both models carry the same weights: a flax parameter tree drawn with numpy
from a seed, fed to the flax model as it is and to the port through
``orion_tpu_torch.convert.params_from_jax``. The JAX side runs its Pallas
kernel in interpret mode (``backend="pallas_interpret"``), as the JAX tests
do; the port's side runs the kernel's plain version (CPU tensors).

Tolerances: fp32 (``TINY``) logits and per-layer (S, z) agree to 1e-4. The
bf16 variant agrees to 5e-2 on logits of unit scale: both sides round every
dense output, norm output and attention output to bf16, XLA and PyTorch's
CPU kernels sum in different orders, and a value near a bf16 rounding
boundary lands on either neighbour (2^-8 relative) and carries through the
next layers.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.models.configs import TINY as JAX_TINY
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu_torch.convert import expected_params, load_jax_params, params_from_jax
from orion_tpu_torch.generate import cast_params_for_inference
from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.models.transformer import (TransformerLM, init_decode_state,
                                                snapshot_decode_state)

torch.set_num_threads(2)

_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}


@functools.lru_cache(maxsize=None)
def _params(seed):
    """A flax param tree for TINY drawn with numpy (no JAX init to trace):
    weights at the flax init scales, norm scales around 1 so that they
    matter."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, (_, shape, transpose) in expected_params(TINY).items():
        shape = shape[::-1] if transpose else shape  # flax kernels are [in, out]
        if path.endswith("scale"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            arr = rng.standard_normal(shape) / np.sqrt(shape[0] if transpose else shape[1])
        node = tree
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": tree}


def _apply(jm, method):
    return jax.jit(functools.partial(jm.apply, method=method))


def _pair(dtype, seed=0, b=2, t=45):
    jm = JaxLM(dataclasses.replace(JAX_TINY, dtype=dtype, backend="pallas_interpret"))
    params = _params(seed)
    tm = load_jax_params(
        TransformerLM(dataclasses.replace(TINY, dtype=dtype), device="cpu"), params
    )
    tokens = np.random.default_rng(seed).integers(0, 256, (b, t), dtype=np.int32)
    return jm, params, cast_params_for_inference(tm), tokens


def _seeded(seed, b=2, t=37):
    tm = TransformerLM(TINY, device="cpu", generator=torch.Generator().manual_seed(seed))
    tokens = np.random.default_rng(seed).integers(0, 256, (b, t), dtype=np.int32)
    return tm, tokens


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_states(got, ref, tol):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for key in ("s", "z"):
            assert g[key].dtype == torch.float32
            scale = max(1.0, float(np.abs(_np(r[key])).max()))
            np.testing.assert_allclose(
                _np(g[key]), _np(r[key]), rtol=tol["rtol"], atol=tol["atol"] * scale
            )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    jm, params, tm, tokens = _pair(dtype)
    tol = _TOL[dtype]
    ref_logits, ref_states = _apply(jm, "prefill_last")(params, jnp.asarray(tokens))
    nxt = np.array([3, 200], dtype=np.int32)
    ref_dec, ref_states2 = _apply(jm, "decode_step")(
        params, jnp.asarray(nxt), ref_states, jnp.int32(tokens.shape[1])
    )
    with torch.no_grad():
        logits, states = tm.prefill_last(torch.from_numpy(tokens).long())
        dec, states2 = tm.decode_step(
            torch.from_numpy(nxt).long(), snapshot_decode_state(states), tokens.shape[1]
        )
    assert logits.dtype == torch.float32 and logits.shape == tuple(ref_logits.shape)
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **tol)
    _close_states(states, ref_states, tol)
    np.testing.assert_allclose(_np(dec), _np(ref_dec), **tol)
    _close_states(states2, ref_states2, tol)


def test_full_forward_and_prefill_logits_match_jax():
    jm, params, tm, tokens = _pair("float32", t=30)
    ref = _apply(jm, "__call__")(params, jnp.asarray(tokens))
    ref_pre, _ = _apply(jm, "prefill")(params, jnp.asarray(tokens))
    with torch.no_grad():
        out = tm(torch.from_numpy(tokens).long())
        pre, _ = tm.prefill(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(out.numpy(), _np(ref), **_TOL["float32"])
    np.testing.assert_allclose(pre.numpy(), _np(ref_pre), **_TOL["float32"])


def test_padded_prefill_with_length_matches_unpadded():
    tm, tokens = _seeded(2)
    padded = np.concatenate([tokens, np.full((2, 8), 7, np.int32)], axis=1)
    with torch.no_grad():
        logits, states = tm.prefill_last(torch.from_numpy(tokens).long())
        plog, pstates = tm.prefill_last(
            torch.from_numpy(padded).long(), length=torch.tensor(37)
        )
    torch.testing.assert_close(plog, logits, rtol=0, atol=0)
    for a, b in zip(pstates, states):
        assert torch.equal(a["s"], b["s"]) and torch.equal(a["z"], b["z"])


def test_bucketed_prefill_with_length_matches_jax():
    jm, params, tm, tokens = _pair("float32", t=40)
    length = 29  # rows past it are padding
    ref_logits, ref_states = jax.jit(
        functools.partial(jm.apply, method="prefill_last")
    )(params, jnp.asarray(tokens), jnp.int32(length))
    with torch.no_grad():
        logits, states = tm.prefill_last(torch.from_numpy(tokens).long(), length=length)
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **_TOL["float32"])
    _close_states(states, ref_states, _TOL["float32"])


def test_decode_from_zero_state_equals_prefill_of_one_token():
    tm, tokens = _seeded(3, t=1)
    tok = torch.from_numpy(tokens[:, 0]).long()
    with torch.no_grad():
        ref, ref_states = tm.prefill_last(tok[:, None])
        got, states = tm.decode_step(tok, init_decode_state(TINY, 2, device="cpu"), 0)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(states, ref_states):
        torch.testing.assert_close(a["s"], b["s"], rtol=1e-5, atol=1e-5)


def test_converter_rejects_bad_trees():
    inner = _params(0)["params"]
    sd = params_from_jax(inner, TINY)  # the bare tree works too
    assert sd["blocks.0.attn.wq.weight"].shape == (128, 128)
    np.testing.assert_array_equal(
        sd["blocks.1.mlp.gate.weight"].numpy(), np.asarray(inner["block_1"]["mlp"]["gate"]["kernel"]).T
    )
    missing = {k: v for k, v in inner.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_jax(missing, TINY)
    extra = dict(inner, lm_head_kernel=np.zeros((128, 256), np.float32))
    with pytest.raises(KeyError, match="lm_head_kernel"):
        params_from_jax(extra, TINY)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(inner, dataclasses.replace(TINY, max_seq_len=256))


def test_unported_configs_raise():
    from orion_tpu_torch.models.configs import get_config

    # hybrid_1b3 is ported: its 24 layers of swa and linear attention build
    # on the CPU (narrowed, so that the test stays small)
    hybrid = dataclasses.replace(get_config("hybrid_1b3"), d_model=128, n_heads=4)
    model = TransformerLM(hybrid, device="cpu")
    kinds = [blk.attn.layer_type for blk in model.blocks]
    assert kinds == list(get_config("hybrid_1b3").layer_types)
    assert kinds.count("swa") == 18 and kinds.count("linear") == 6
    assert all(not k.endswith("freqs") for k in model.state_dict())
    # moe_1b3_4e is ported: blocks 3, 7, ..., 23 route over 4 experts
    moe = dataclasses.replace(get_config("moe_1b3_4e"), d_model=128, n_heads=4)
    routed = [i for i, blk in enumerate(TransformerLM(moe, device="cpu").blocks)
              if hasattr(blk.mlp, "router")]
    assert routed == [3, 7, 11, 15, 19, 23]
    # LayerNorm and the classifier are ported (tests/test_torch_lra.py): an
    # lra_* config builds its LM with LayerNorm, and its classifier
    lra = dataclasses.replace(get_config("lra_text_linear"), max_seq_len=64)
    assert type(TransformerLM(lra, device="cpu").final_norm).__name__ == "LayerNorm"
    from orion_tpu_torch.models.classifier import LRAClassifier

    assert LRAClassifier(lra, device="cpu")(torch.zeros(1, 8, dtype=torch.long)).shape == (1, 2)
    # quantized serving is ported (tests/test_torch_quant_model.py): only an
    # unknown mode raises
    with pytest.raises(ValueError, match="quant must be"):
        TransformerLM(TINY, device="cpu", quant="int2")
    with pytest.raises(NotImplementedError, match="parallelism"):
        TransformerLM(TINY, device="cpu", mesh=object())
