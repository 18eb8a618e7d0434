"""Model and training options of the port held against the JAX package's on
the CPU: the ``favor`` and ``learnable`` feature maps, the untied head (full
precision and int8), ``remat_policy="dots"``, and bf16 parameter storage
with stochastic rounding (``param_storage="bfloat16_sr"``).

Weights are a flax tree drawn with numpy from a seed, carried to the port
by ``convert.load_jax_params``. The JAX side runs its plain XLA forms
(``backend="xla"``); the port's its plain versions (CPU tensors).
Tolerances, as ``test_torch_model.py`` / ``test_torch_training.py`` /
``test_torch_quant_model.py`` state them: fp32 logits and (S, z) states
1e-4; bf16 logits 5e-2 on logits of unit scale; the loss 1e-5 and every
gradient 1e-4 relative plus 1e-5 of its largest magnitude; greedy tokens
exactly; int8 scales within one fp32 ulp. Inside the port, the ``dots``
gradients are bitwise those of ``full`` and of no remat, and the stochastic
rounding is bitwise the JAX package's for the same two key words.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orion_tpu.generate import quantize_for_decode as jax_quantize_for_decode
from orion_tpu.models.configs import TINY as JAX_TINY
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.training import trainer as jax_trainer
from orion_tpu_torch import generate as gen
from orion_tpu_torch.convert import expected_params, load_jax_params, params_from_jax
from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.models.transformer import TransformerLM
from orion_tpu_torch.ops.feature_maps import favor_features, make_feature_map, register_feature_map
from orion_tpu_torch.ops.kernels import causal_dot
from orion_tpu_torch.training import trainer as tr

torch.set_num_threads(2)

_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
OPTIONS = {
    "favor": dict(feature_map="favor"),
    "learnable_untied": dict(feature_map="learnable", tie_embeddings=False),
    "untied": dict(tie_embeddings=False),
}


def cfgs(name, dtype="float32", **extra):
    """(the port's config, the JAX package's on its XLA forms)."""
    over = dict(OPTIONS[name], dtype=dtype, **extra)
    return (dataclasses.replace(TINY, **over),
            dataclasses.replace(JAX_TINY, backend="xla", **over))


@functools.lru_cache(maxsize=None)
def tree(name, seed=0):
    """A flax param tree drawn with numpy at the flax init scales, norm
    scales around 1, a FAVOR+ projection of Gaussian rows."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, (_, shape, transpose) in expected_params(cfgs(name)[0]).items():
        shape = shape[::-1] if transpose else shape  # flax kernels are [in, out]
        if path.endswith("scale"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif path.endswith("favor_proj"):
            arr = rng.standard_normal(shape)
        else:
            arr = rng.standard_normal(shape) / np.sqrt(shape[0] if transpose else shape[1])
        node = out
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": out}


def _jtree(name):
    return jax.tree.map(jnp.asarray, tree(name))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(seed, b=2, t=29):
    return np.random.default_rng(seed).integers(0, 256, (b, t), dtype=np.int32)


def _jax_greedy(jm, params, prompt, steps):
    @jax.jit
    def run(p, prompt):
        logits, states = jm.apply(p, prompt, method="prefill_last")

        def step(carry, i):
            lg, st = carry
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            lg, st = jm.apply(p, tok, st, prompt.shape[1] + i, method="decode_step")
            return (lg, st), (tok, lg)

        (_, last_states), (toks, dec) = jax.lax.scan(step, (logits, states), jnp.arange(steps))
        return logits, states, toks.T, dec, last_states

    return run(params, jnp.asarray(prompt))


@pytest.mark.parametrize("name", list(OPTIONS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_states_and_greedy_decode_match_jax(name, dtype):
    """The prefill's logits and per-layer (S, z), then 6 greedy decode
    steps: tokens exactly, logits and the final states within the limits."""
    cfg, jcfg = cfgs(name, dtype)
    tol = _TOL[dtype]
    logits_r, states_r, toks_r, dec_r, last_r = _jax_greedy(JaxLM(jcfg), _jtree(name),
                                                            _tokens(1), 6)
    model = gen.cast_params_for_inference(load_jax_params(TransformerLM(cfg, device="cpu"),
                                                          tree(name)))
    prompt = torch.from_numpy(_tokens(1)).long()
    toks = gen.generate(model, prompt, 7, gen.SampleConfig(temperature=0.0))
    np.testing.assert_array_equal(toks.numpy()[:, :6], np.asarray(toks_r))
    with torch.no_grad():
        logits, states = model.prefill_last(prompt)
        np.testing.assert_allclose(_np(logits), _np(logits_r), **tol)
        for got_states, ref_states in ((states, states_r),):
            for g, r in zip(got_states, ref_states):
                for key in ("s", "z"):
                    scale = max(1.0, float(np.abs(_np(r[key])).max()))
                    np.testing.assert_allclose(_np(g[key]), _np(r[key]), rtol=tol["rtol"],
                                               atol=tol["atol"] * scale)
        dec = []
        for i in range(6):
            lg, states = model.decode_step(toks[:, i], states, prompt.shape[1] + i)
            dec.append(lg)
    np.testing.assert_allclose(torch.stack(dec).numpy(), _np(dec_r), **tol)
    for g, r in zip(states, last_r):
        scale = max(1.0, float(np.abs(_np(r["s"])).max()))
        np.testing.assert_allclose(_np(g["s"]), _np(r["s"]), rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


def _close(got, ref, rtol, atol_of_max, name=""):
    got, ref = _np(got), np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_of_max * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=name)


_BATCH = np.random.default_rng(4).integers(0, TINY.vocab_size, (2, 41)).astype(np.int32)


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """The kernel backend's three wrappers, stood in for by their plain
    versions (this machine has no card): ``LinearAttentionFn`` runs its
    forward and its two backward passes through them."""
    monkeypatch.setattr(causal_dot, "causal_dot_norm_cuda", causal_dot.causal_dot_norm_plain)
    monkeypatch.setattr(causal_dot, "causal_dot_dq_den_cuda", causal_dot.causal_dot_dq_den_plain)
    monkeypatch.setattr(causal_dot, "causal_dot_rev_den_cuda", causal_dot.causal_dot_rev_den_plain)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name):
    cfg, jcfg = cfgs(name)
    jm = JaxLM(jcfg)
    loss_r, grads_r = jax.jit(jax.value_and_grad(
        lambda p: jax_trainer.lm_loss(jm, p, jnp.asarray(_BATCH))))(_jtree(name))
    return float(loss_r), params_from_jax(jax.device_get(grads_r), cfg)


@pytest.mark.parametrize("name", list(OPTIONS))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_loss_and_grads_match_jax(name, backend, kernels_as_plain):
    """lm_loss through the fused head (the untied head enters as its
    transpose) and every gradient; the fixed favor_proj gets zeros on both
    sides."""
    cfg = cfgs(name)[0]
    loss_r, ref = _jax_loss_and_grads(name)
    model = load_jax_params(TransformerLM(dataclasses.replace(cfg, backend=backend),
                                          device="cpu"), tree(name))
    loss = tr.lm_loss(model, torch.from_numpy(_BATCH).long())
    loss.backward()
    _close(loss, loss_r, 1e-5, 0.0, "loss")
    for n, g in tr.param_grads(dict(model.named_parameters())).items():
        _close(g, ref[n], 1e-4, 1e-5, n)
        if n.endswith("favor_proj"):
            assert not model.get_parameter(n).requires_grad and not g.any()


def test_favor_and_learnable_feature_maps():
    """make_feature_map("favor") is FAVOR+ over an orthogonal-Gaussian
    projection drawn from the generator (the JAX package's formula, held
    against it through the models above); "learnable" lives in the
    attention module; both names stay reserved."""
    from orion_tpu_torch.ops.feature_maps import _orthogonal_gaussian, favor_phi

    fm = make_feature_map("favor", generator=torch.Generator().manual_seed(0), dim=16)
    w = _orthogonal_gaussian(16, 16, torch.Generator().manual_seed(0))
    gram = w @ w.t()  # orthogonal rows, each scaled by a Gaussian vector's norm
    torch.testing.assert_close(gram - torch.diag(torch.diag(gram)), torch.zeros(16, 16),
                               atol=1e-4, rtol=0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 5, 16)).astype(np.float32))
    assert fm.out_dim == 16 and torch.equal(fm(x), favor_phi(x, w))
    xs = x.numpy() / 16 ** 0.25
    ref = np.exp(xs @ w.numpy().T - 0.5 * (xs * xs).sum(-1, keepdims=True)) / 4.0
    np.testing.assert_allclose(fm(x).numpy(), ref, rtol=1e-5, atol=1e-7)
    assert fm(x.to(torch.bfloat16)).dtype == torch.bfloat16
    assert favor_features(16, 32, generator=torch.Generator().manual_seed(1)).out_dim == 32
    with pytest.raises(ValueError, match="generator"):
        make_feature_map("favor")
    with pytest.raises(ValueError, match="unknown"):
        make_feature_map("learnable")
    for name in ("favor", "learnable", "elu1"):
        with pytest.raises(ValueError, match="built-in"):
            register_feature_map(name, torch.exp)


def test_untied_int8_head_matches_jax():
    """The untied head at int8 after quantize_for_decode: the port's
    lm_head_kernel_q / _s against the JAX package's quantization of the same
    fp32 tree (scales within 1 ulp, integers equal), then the JAX quantized
    model on the port's quantized weights: prefill logits, greedy tokens and
    decode logits."""
    cfg, jcfg = cfgs("untied")
    fp = load_jax_params(TransformerLM(cfg, device="cpu"), tree("untied"))
    m = gen.quantize_for_decode(fp, "int8")
    ours = m.state_dict()
    assert ours["lm_head_kernel_q"].dtype == torch.int8
    assert ours["lm_head_kernel_q"].shape == (cfg.d_model, cfg.vocab_size)
    _, qp = jax_quantize_for_decode(JaxLM(jcfg), _jtree("untied"), mode="int8")
    theirs = params_from_jax(jax.device_get(qp), cfg, "int8")
    np.testing.assert_array_max_ulp(ours["lm_head_kernel_s"].numpy(),
                                    theirs["lm_head_kernel_s"].numpy(), maxulp=1)
    assert torch.equal(ours["lm_head_kernel_q"], theirs["lm_head_kernel_q"])
    qm = JaxLM(jcfg, quant="int8")
    flat = {path: ours[key].numpy().T if t else ours[key].numpy()
            for path, (key, _, t) in expected_params(cfg, "int8").items()}
    qtree = {}
    for path, arr in flat.items():
        node = qtree
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    logits_r, _, toks_r, dec_r, _ = _jax_greedy(qm, {"params": qtree}, _tokens(2, t=16), 6)
    prompt = torch.from_numpy(_tokens(2, t=16)).long()
    toks = gen.generate(m, prompt, 7, gen.SampleConfig(temperature=0.0), quant="int8")
    np.testing.assert_array_equal(toks.numpy()[:, :6], np.asarray(toks_r))
    with torch.inference_mode():
        logits, states = m.prefill_last(prompt)
        dec = []
        for i in range(6):
            lg, states = m.decode_step(toks[:, i], states, prompt.shape[1] + i)
            dec.append(lg)
    np.testing.assert_allclose(logits.numpy(), _np(logits_r), **_TOL["float32"])
    np.testing.assert_allclose(torch.stack(dec).numpy(), _np(dec_r), **_TOL["float32"])


@pytest.mark.parametrize("name", ["favor", "learnable_untied"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_remat_dots_grads_bitwise_equal_full_and_no_remat(name, backend, kernels_as_plain):
    """remat_policy="dots" keeps the products' outputs and recomputes the
    rest (the attention Function's launches included): the same gradients,
    bitwise, as "full" and as no remat."""
    batch = torch.from_numpy(_BATCH).long()
    grads = {}
    for label, over in (("none", dict(remat=False)), ("full", dict(remat=True)),
                        ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = dataclasses.replace(cfgs(name)[0], backend=backend, remat_skip=0, **over)
        model = load_jax_params(TransformerLM(cfg, device="cpu"), tree(name))
        tr.lm_loss(model, batch).backward()
        grads[label] = tr.param_grads(dict(model.named_parameters()))
    for n, g in grads["none"].items():
        assert torch.equal(grads["full"][n], g), n
        assert torch.equal(grads["dots"][n], g), n


def test_an_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        TransformerLM(dataclasses.replace(TINY, remat_policy="offload"), device="cpu")


# ---------------------------------------------------------------------------
# bf16 storage with stochastic rounding
# ---------------------------------------------------------------------------

_WORDS = [(0, 0), (0xDEADBEEF, 0x12345678), (0xFFFFFFFF, 1), (7, 0xFFFFFFFF)]


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("words", _WORDS)
def test_sr_round_bf16_bitwise_equals_jax(words):
    x = (np.random.default_rng(sum(words) % 1000).standard_normal(20011) * 3.0).astype(np.float32)
    x[:6] = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7F800000, 0xFF800000, 0x7F7FFFFF],
                     np.uint32).view(np.float32)
    ref = np.asarray(jax_trainer.sr_round_bf16(jnp.asarray(x),
                                               jnp.asarray(np.array(words, np.uint32))))
    got = tr.sr_round_bf16(torch.from_numpy(x), words)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), ref.view(np.uint16))
    noise = np.asarray(jax_trainer._sr_noise_bits(jnp.asarray(np.array(words, np.uint32)), 257))
    np.testing.assert_array_equal(tr.sr_noise_bits(words, 257).numpy(), noise.astype(np.int64))


def test_sr_round_bf16_is_unbiased_and_keeps_representable_values():
    x = torch.tensor([1.0 + 2.0 ** -9, -3.0 - 3 * 2.0 ** -10, 1e-3, 0.3])
    draws = torch.stack([tr.sr_round_bf16(x, tr.key_words(tr.rngs.fold(5, i))).float()
                         for i in range(4000)])
    lo = x.to(torch.bfloat16).float()  # each draw is one of the two neighbours
    assert bool(((draws == draws.min(0).values) | (draws == draws.max(0).values)).all())
    spread = (draws.max(0).values - draws.min(0).values)
    # mean within 4 standard errors of x: the rounding is unbiased
    assert bool(((draws.mean(0) - x).abs() <= 4 * spread / (2 * 4000 ** 0.5) + 1e-9).all())
    assert bool((spread > 0).all()) and lo.shape == x.shape
    rep = torch.randn(1000).to(torch.bfloat16).float()  # representable: bitwise unchanged
    for w in _WORDS:
        assert torch.equal(tr.sr_round_bf16(rep, w), rep.to(torch.bfloat16))
    nf = torch.tensor([float("inf"), -float("inf"), float("nan")])
    out = tr.sr_round_bf16(nf, (1, 2)).float()
    assert out[0] == float("inf") and out[1] == -float("inf") and torch.isnan(out[2])


def _tcfg(**kw):
    return tr.TrainConfig(model=dataclasses.replace(TINY, **kw.pop("model", {})), steps=3,
                          batch_size=2, seq_len=32, warmup_steps=1, lr=1e-3, **kw)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (2, 33))).long() for _ in range(n)]


def test_an_adamw_step_leaves_favor_proj_undecayed_as_jax():
    """optax adamw with the JAX package's _wd_mask against the port's
    optimizer on the same params and gradients: favor_proj is masked out
    of the weight decay (its gradient is 0, so it does not move), the other
    matrices decay."""
    cfg = cfgs("favor")[0]
    tc = tr.TrainConfig(model=cfg, steps=10, lr=1e-2, warmup_steps=1, weight_decay=0.1)
    model = load_jax_params(TransformerLM(cfg, device="cpu"), tree("favor"))
    tr.lm_loss(model, torch.from_numpy(_BATCH).long()).backward()
    params = dict(model.named_parameters())
    grads = tr.param_grads(params)
    before = {n: p.detach().clone() for n, p in params.items()}
    opt = tr.Optimizer(tc, params)
    for _ in range(2):  # the first step's lr is 0 under warmup
        opt.update(params, {n: g.clone() for n, g in grads.items()})
    jtc = jax_trainer.TrainConfig(model=cfgs("favor")[1], steps=10, lr=1e-2, warmup_steps=1,
                                  weight_decay=0.1, clip_norm=0.0)
    tx = jax_trainer.make_optimizer(jtc)
    p = _jtree("favor")
    state = tx.init(p)
    g_tree = jax.tree.map(jnp.asarray, _flax_like(tree("favor"), grads, cfg))
    for _ in range(2):
        upd, state = tx.update(g_tree, state, p)
        p = optax.apply_updates(p, upd)
    ref = params_from_jax(jax.device_get(p), cfg)
    for n, q in params.items():
        _close(q, ref[n], 1e-6, 1e-7, n)
        if n.endswith("favor_proj"):
            assert torch.equal(q, before[n]), n
        elif q.dim() == 2:
            assert not torch.equal(q, before[n]), n


def _flax_like(like, state, cfg):
    """A port state (by torch key) as a flax tree shaped like ``like``."""
    out = {}
    for path, (key, _, t) in expected_params(cfg).items():
        arr = state[key].detach().numpy()
        node = out
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr.T if t else arr
    return {"params": out}


def test_trainer_with_favor_keeps_the_projection():
    trainer = tr.Trainer(_tcfg(model=dict(feature_map="favor"), weight_decay=0.5), device="cpu")
    before = {n: p.clone() for n, p in trainer.params.items() if n.endswith("favor_proj")}
    for b in _batches(3):
        assert np.isfinite(trainer.step(b)["loss"])
    assert before and all(torch.equal(trainer.params[n], p) for n, p in before.items())


@pytest.mark.parametrize("optimizer", ["adamw", "lion", "adafactor"])
def test_bf16_sr_storage_trains_and_resumes_bitwise(optimizer, tmp_path):
    """Matrix params bf16, 1-D params and the optimizer state fp32; the
    loss finite; a run resumed from a checkpoint (bf16 leaves saved and
    loaded as bf16) equals the uninterrupted one bitwise (the roundings
    replay)."""
    from orion_tpu_torch.training.checkpoint import Checkpointer

    tc = _tcfg(param_storage="bfloat16_sr", optimizer=optimizer)
    batches = _batches(3)
    a = tr.Trainer(tc, device="cpu")
    for n, p in a.params.items():
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32), n
    losses = [a.step(b)["loss"] for b in batches]
    assert all(np.isfinite(x) for x in losses)
    b_ = tr.Trainer(tc, device="cpu")
    b_.step(batches[0])
    ckpt = Checkpointer(str(tmp_path), save_every=1)
    ckpt.maybe_save(1, b_.state_dict(), force=True)
    c = tr.Trainer(tc, device="cpu")
    assert c.restore(ckpt) == 1
    assert ckpt.restore(1)["params"]["blocks.0.attn.wq.weight"].dtype == torch.bfloat16
    for b in batches[1:]:
        c.step(b)
    for n, p in a.params.items():
        assert torch.equal(p, c.params[n]), n
    opt_state = a.opt.state_dict()
    for key in ("mu", "nu", "v_row", "v_col", "v"):
        for n, t in opt_state.get(key, {}).items():
            assert t.dtype == torch.float32, (key, n)


def test_a_bf16_sr_step_is_one_of_the_two_neighbours_of_jaxs_fp32_update():
    """One AdamW step with bf16 storage from the same bf16 weights and
    batch in both packages: the keys differ (threefry against the port's
    seeds), so each side's element is one of the two bf16 neighbours of its
    fp32 value p + u; the two fp32 values differ in their last bits and may
    straddle a bf16 value, so the two packages agree within two bf16 steps
    (the updates reach ten steps at the weights' scale), plus 2^-7 of the
    leaf's largest update: both gradients are bf16 (a bf16 leaf's gradient
    takes its dtype), rounded from sums taken in another order. (eps 1e-2
    keeps Adam's first update continuous in the gradient: with eps 1e-8 a
    gradient within rounding of 0 steps by +-lr on either side.)"""
    cfg, jcfg = cfgs("untied")
    common = dict(steps=5, batch_size=2, seq_len=40, lr=1e-2, warmup_steps=1, eps=1e-2,
                  param_storage="bfloat16_sr")
    tc = tr.TrainConfig(model=cfg, **common)
    jt = jax_trainer.Trainer(jax_trainer.TrainConfig(model=jcfg, mesh=jax_trainer.MeshConfig(dp=1),
                                                     **common))
    ours = tr.Trainer(tc, device="cpu")
    # the JAX trainer's initial bf16 / fp32 leaves into the port
    init = params_from_jax(jax.device_get(jt.state.params), cfg)
    with torch.no_grad():
        for n, p in ours.params.items():
            p.copy_(init[n].to(p.dtype))
    batch = np.random.default_rng(9).integers(0, 256, (2, 41)).astype(np.int32)
    for _ in range(2):  # step 0's lr is 0 under warmup
        jt.step(jnp.asarray(batch))
        ours.step(torch.from_numpy(batch).long())
    ref = params_from_jax(jax.device_get(jt.state.params), cfg)
    for n, p in ours.params.items():
        r = ref[n]
        if p.dtype == torch.bfloat16:
            step = torch.maximum(p.float().abs(), r.abs()) * 2.0 ** -7  # >= the bf16 spacing
            moved = (r - init[n].float()).abs()
            assert bool(((p.float() - r).abs() <= 2 * step + 2.0 ** -7 * moved.max()).all()), n
        else:
            _close(p, r, 1e-3, 1e-4, n)


def test_bf16_sr_with_the_fused_adafactor_raises():
    with pytest.raises(ValueError, match="bfloat16_sr"):
        tr.Trainer(_tcfg(param_storage="bfloat16_sr", optimizer="adafactor_fused"),
                   device="cpu")
