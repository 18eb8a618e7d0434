"""The port's MoE layer and grouped matmul held against the JAX package's,
on the CPU.

Inputs and parameters are drawn with numpy from a seed and handed to both
sides. The JAX grouped matmul runs its Pallas kernels in interpret mode
(``interpret=True``, ``backend="pallas_interpret"``); the port's side runs
the kernels' plain versions (CPU tensors), and ``GmmFn`` with the plain
versions standing in for the two kernels.

Tolerances (fp32 throughout): routing (ids, dispatch, capacity positions)
exactly; gates, combine weights, layer outputs and the auxiliary loss to
1e-5 relative and absolute (the same fp32 products summed in another order,
through one softmax); the grouped matmul to 1e-5 and its gradients to 1e-4
relative plus 1e-5 of their largest magnitude (sums over up to 512 rows);
an expert without tiles gets a dw of exactly 0. The layer's gradients add a
floor of 2e-5 (``GRAD_FLOOR``): at top-1 the gates are g / g = 1, whose
gradient vanishes in exact arithmetic, and each side keeps an fp32 residue
of about 2^-24 of the gate's cotangent (|y . cot| ~ 10) per token, which the
router's gradient sums over 1024 tokens of |x| ~ 3 (5.6e-6 measured, on a
gradient whose largest element is 3.4e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.moe import MoEMLP as JaxMoEMLP
from orion_tpu.models.moe import _counting_sort_perm as jax_counting_sort_perm
from orion_tpu.models.moe import top_k_choice as jax_top_k_choice
from orion_tpu.models.moe import top_k_routing as jax_top_k_routing
from orion_tpu.ops.pallas.gmm import gmm as jax_gmm
from orion_tpu.ops.pallas.gmm import tile_expert_table as jax_tile_expert_table
from orion_tpu_torch.models import moe
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.ops.kernels import gmm as gm

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_FLOOR = 2e-5


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _probs(n, e, seed):
    logits = np.random.default_rng(seed).standard_normal((n, e)).astype(np.float32) * 2
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))  # a writable copy


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_choice_matches_jax(k):
    p = _probs(64, 4, k)
    ids_r, gates_r = jax.jit(jax_top_k_choice, static_argnums=1)(jnp.asarray(p), k)
    ids, gates = moe.top_k_choice(torch.from_numpy(p), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r), **TOL)


@pytest.mark.parametrize("k,capacity", [(1, 40), (1, 9), (2, 12), (2, 64)])
def test_top_k_routing_matches_jax(k, capacity):
    """Capacities from ample to tight enough to drop tokens (9 and 12 of 32
    tokens x k slots over 4 experts), three groups at once on the port's
    side against the JAX function vmapped over the groups."""
    p = np.stack([_probs(32, 4, 10 + g) for g in range(3)])
    got = moe.top_k_routing(torch.from_numpy(p), k, capacity)
    routing = jax.jit(jax.vmap(jax_top_k_routing, in_axes=(0, None, None)), static_argnums=(1, 2))
    refs = routing(jnp.asarray(p), k, capacity)
    for g in range(3):
        ref = [r[g] for r in refs]
        np.testing.assert_array_equal(got[0][g].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(got[1][g].numpy(), np.asarray(ref[1]), **TOL)
        np.testing.assert_allclose(got[2][g].numpy(), np.asarray(ref[2]), **TOL)
    if capacity < 32 * k // 4:
        assert int(got[0].sum()) < 3 * 32 * k  # some (token, slot) was dropped


def test_counting_sort_and_group_size_match_jax():
    flat = np.random.default_rng(3).integers(0, 5, 300)
    ref = jax.jit(jax_counting_sort_perm, static_argnums=1)(jnp.asarray(flat, jnp.int32), 5)
    got = moe.counting_sort_perm(torch.from_numpy(flat), 5)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [moe.group_size(t, 512) for t in (40, 1024, 1536, 600)] == [40, 512, 512, 300]


# ---------------------------------------------------------------------------
# The grouped matmul (rows 9 and 10)
# ---------------------------------------------------------------------------

_SEG = np.array([16, 0, 32], np.int32)  # tile-aligned at tm 16, one expert empty


def _gmm_inputs(seed, m=64, d=16, h=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w = (rng.standard_normal((3, d, h)) * 0.1).astype(np.float32)
    return x, w


def _table(m, tm=16):
    return gm.tile_expert_table(torch.from_numpy(_SEG), m // tm, tm)


def test_tile_tables_match_jax():
    te = _table(64)
    np.testing.assert_array_equal(te.numpy(), np.asarray(jax_tile_expert_table(
        jnp.asarray(_SEG), 4, 16)))
    assert te.dtype == torch.int32
    start, count = gm.expert_tiles(te, 3)
    assert start.tolist() == [0, 1, 1] and count.tolist() == [1, 0, 3]
    seg, starts = gm.pad_group_sizes(torch.tensor([5, 0, 17, 16]), 16)
    assert seg.tolist() == [16, 0, 32, 16] and starts.tolist() == [0, 16, 16, 48]


def test_gmm_plain_matches_jax_interpret():
    x, w = _gmm_inputs(0)
    ref = jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(_SEG), 16, 16, True)
    got = gm.gmm_torch(torch.from_numpy(x), torch.from_numpy(w), _table(64))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # dx's form: the same rows against w[e]^T, read in place
    g = np.random.default_rng(1).standard_normal((64, 24)).astype(np.float32)
    ref_t = jax_gmm(jnp.asarray(g), jnp.swapaxes(jnp.asarray(w), 1, 2), jnp.asarray(_SEG), 16,
                    16, True)
    got_t = gm.gmm_torch(torch.from_numpy(g), torch.from_numpy(w), _table(64), transpose_w=True)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), **TOL)


@pytest.fixture
def gmm_kernels_as_plain(monkeypatch):
    """The two gmm kernel wrappers, stood in for by their plain versions."""
    monkeypatch.setattr(gm, "gmm_cuda", gm.gmm_torch)
    monkeypatch.setattr(gm, "gmm_dw_cuda", gm.gmm_dw_torch)


@pytest.mark.parametrize("through", ["GmmFn", "autograd"])
def test_gmm_grads_match_jax_interpret(through, gmm_kernels_as_plain):
    """GmmFn's backward (dx by the forward kernel against w^T, dw by the dw
    kernel) and autograd through the plain version against jax.grad of the
    interpret-mode kernels; the empty expert's dw is exactly 0."""
    x, w = _gmm_inputs(2)

    def jax_loss(x, w):
        return (jax_gmm(x, w, jnp.asarray(_SEG), 16, 16, True) ** 2).sum()

    gx_r, gw_r = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    te = _table(64)
    y = gm.GmmFn.apply(xt, wt, te) if through == "GmmFn" else gm.gmm(xt, wt, te)
    (y ** 2).sum().backward()
    for got, ref in ((xt.grad, gx_r), (wt.grad, gw_r)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())
    assert float(wt.grad[1].abs().max()) == 0.0


def test_gmm_dw_plain_of_an_absent_expert_is_zero():
    x, _ = _gmm_inputs(4)
    g = torch.randn(64, 24)
    dw = gm.gmm_dw_torch(torch.from_numpy(x), g, _table(64), 3)
    assert dw.dtype == torch.float32 and bool((dw[1] == 0).all())
    ref = torch.from_numpy(x)[:16].t() @ g[:16]
    torch.testing.assert_close(dw[0], ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

D, H = 32, 48


def _cfgs(**kw):
    base = dict(name="t", d_model=D, mlp_hidden=H, n_experts=4, dtype="float32", **kw)
    return ModelConfig(**base), JaxModelConfig(**base)


def _layer_params(mlp="swiglu", seed=0):
    """A flax MoEMLP param tree drawn with numpy at the flax init scales."""
    rng = np.random.default_rng(seed)
    p = {"router": {"kernel": rng.standard_normal((D, 4)) / np.sqrt(D)},
         "experts_up": rng.standard_normal((4, D, H)) / np.sqrt(D),
         "experts_down": rng.standard_normal((4, H, D)) / np.sqrt(H)}
    if mlp == "swiglu":
        p["experts_gate"] = rng.standard_normal((4, D, H)) / np.sqrt(D)
    return {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), p)}


def _port_layer(cfg, tree):
    layer = moe.MoEMLP(cfg, torch.float32, device="cpu")
    p = tree["params"]
    with torch.no_grad():
        layer.router.copy_(torch.from_numpy(p["router"]["kernel"].T))
        for name in ("experts_gate", "experts_up", "experts_down"):
            if name in p:
                getattr(layer, name).copy_(torch.from_numpy(p[name]))
    return layer


def _jax_apply(jcfg, tree, x):
    y, state = jax.jit(lambda p, x: JaxMoEMLP(jcfg).apply(p, x, mutable=["losses"]))(
        tree, jnp.asarray(x))
    return np.asarray(y), float(jax.tree.leaves(state["losses"])[0])


def _x(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "k,shape,mlp,cf",
    [
        (1, (2, 40, D), "swiglu", 1.25),  # train shape, drops tokens
        (2, (2, 40, D), "swiglu", 1.0),
        (2, (3, 24, D), "gelu", 2.0),
        (1, (5, D), "swiglu", 1.25),  # decode: one group, C = B
        (2, (5, D), "gelu", 1.0),
    ],
)
def test_capacity_layer_matches_jax(k, shape, mlp, cf):
    cfg, jcfg = _cfgs(moe_top_k=k, mlp=mlp, moe_capacity_factor=cf, moe_group_size=20)
    tree = _layer_params(mlp)
    x = _x(shape)
    ref, aux_r = _jax_apply(jcfg, tree, x)
    y, aux = _port_layer(cfg, tree)(torch.from_numpy(x), with_aux=True)
    np.testing.assert_allclose(_np(y), ref, **TOL)
    np.testing.assert_allclose(float(aux.detach()), aux_r, **TOL)


@pytest.mark.parametrize("k,shape,mlp", [(1, (2, 40, D), "swiglu"), (2, (3, 24, D), "gelu"),
                                         (2, (6, D), "swiglu")])
def test_dropless_ragged_and_dense_forms_match_jax(k, shape, mlp):
    """The ragged form (what CPU tensors take) and the dense per-expert form
    (what the card takes below 1024 routed rows, decode's form) against the
    JAX ragged_dot form."""
    cfg, jcfg = _cfgs(moe_top_k=k, mlp=mlp, moe_dropless=True)
    jcfg = dataclasses.replace(jcfg, backend="xla")
    tree = _layer_params(mlp, seed=1)
    x = _x(shape, seed=6)
    ref, aux_r = _jax_apply(jcfg, tree, x)
    layer = _port_layer(cfg, tree)
    y, aux = layer(torch.from_numpy(x), with_aux=True)
    np.testing.assert_allclose(_np(y), ref, **TOL)
    np.testing.assert_allclose(float(aux.detach()), aux_r, **TOL)
    x2 = torch.from_numpy(x).reshape(-1, D)
    ids, gates = moe.top_k_choice(torch.softmax(layer._logits(x2), -1), k)
    dense = layer._dropless_dense(x2, ids, gates)
    np.testing.assert_allclose(_np(dense).reshape(ref.shape), ref, **TOL)


@pytest.fixture
def tile_aligned_form(monkeypatch, gmm_kernels_as_plain):
    """CPU tensors routed as the card routes them: the dropless gate and gmm
    both resolve the backend to "cuda", so the layer takes the tile-aligned
    form and ``GmmFn``, whose kernels the plain versions stand in for."""
    monkeypatch.setattr(moe, "resolve", lambda backend, device: "cuda")
    monkeypatch.setattr(gm, "resolve", lambda backend, device: "cuda")


@pytest.mark.parametrize("k,mlp", [(1, "swiglu"), (2, "gelu")])
def test_tile_aligned_form_matches_jax_dropless_gmm(k, mlp, tile_aligned_form):
    """The port's tile-aligned form (128-row tiles, GmmFn) against the JAX
    package's ``_dropless_gmm`` on its interpret-mode kernels, at 1024 / 2048
    routed rows (the gate's threshold): values, the auxiliary loss, and the
    gradients of x and every parameter."""
    cfg, jcfg = _cfgs(moe_top_k=k, mlp=mlp, moe_dropless=True)
    jcfg = dataclasses.replace(jcfg, backend="pallas_interpret")
    tree = _layer_params(mlp, seed=2)
    x = _x((2, 512, D), seed=7)
    cot = _x((2, 512, D), seed=8)

    def jax_loss(p, x):
        y, state = JaxMoEMLP(jcfg).apply(p, x, mutable=["losses"])
        return (y * cot).sum() + jax.tree.leaves(state["losses"])[0]

    loss_r, (gp, gx) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        tree, jnp.asarray(x))
    layer = _port_layer(cfg, tree)
    before = gm.launches_fwd
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = layer(xt, with_aux=True)
    loss = (y * torch.from_numpy(cot)).sum() + aux
    loss.backward()
    assert gm.launches_fwd == before  # the plain versions stood in: no kernel ran
    np.testing.assert_allclose(float(loss.detach()), float(loss_r), rtol=1e-5)
    refs = {"x": gx, "router": np.asarray(gp["params"]["router"]["kernel"]).T,
            **{n: gp["params"][n] for n in ("experts_gate", "experts_up", "experts_down")
               if n in gp["params"]}}
    grads = {"x": xt.grad, **{n: p.grad for n, p in layer.named_parameters()}}
    assert set(grads) == set(refs)
    for name, ref in refs.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(grads[name]), ref, rtol=1e-4,
                                   atol=GRAD_FLOOR + 1e-5 * np.abs(ref).max(), err_msg=name)


def test_tile_aligned_form_takes_the_gate(tile_aligned_form, monkeypatch):
    """The gate: 1024 routed rows or more take the tile-aligned form, fewer
    the dense form on the card and the ragged form on the CPU."""
    cfg, _ = _cfgs(moe_dropless=True)
    layer = _port_layer(cfg, _layer_params())
    taken = []
    for form in ("_dropless_gmm", "_dropless_ragged"):
        real = getattr(layer, form)
        monkeypatch.setattr(layer, form, lambda *a, f=form, r=real: (taken.append(f), r(*a))[1])
    with torch.no_grad():
        layer(torch.from_numpy(_x((2, 512, D))))
        layer(torch.from_numpy(_x((2, 511, D))))
    assert taken == ["_dropless_gmm", "_dropless_ragged"]


def test_unported_forms_raise():
    cfg, _ = _cfgs()
    with pytest.raises(NotImplementedError, match="item 12"):
        moe.MoEMLP(cfg, torch.float32, device="cpu", mesh=object())
    # int8 expert stacks are ported (tests/test_torch_quant_model.py)
    assert moe.MoEMLP(cfg, torch.float32, device="cpu", quant="int8").experts_up_q.dtype == \
        torch.int8
    with pytest.raises(ValueError, match="quant must be"):
        moe.MoEMLP(cfg, torch.float32, device="cpu", quant="int2")
    with pytest.raises(ValueError, match="moe_top_k"):
        moe.MoEMLP(dataclasses.replace(cfg, moe_top_k=5), torch.float32, device="cpu")
