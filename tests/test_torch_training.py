"""The port's training slice held against the JAX package's, on the CPU.

Inputs and weights are drawn with numpy from a seed and handed to both.
Tolerances (all fp32): the fused cross entropy's loss, dx and dw agree to
1e-5 relative and 1e-6 of their largest magnitude (the same exact products
summed in another order); ``TINY``'s loss to 1e-5 and every parameter's
gradient to 1e-4 relative plus 1e-5 of its largest magnitude (24 more
layers of fp32 sums in another order, through attention's normalizer);
schedules to 1e-6 relative (both in fp32; a cosine may differ in its last
bit); optimizer steps to 1e-6 relative plus 1e-7 absolute (the
same fp32 formulas, with bias corrections rounded at another point).
Datasets are compared bitwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orion_tpu.models.configs import TINY as JAX_TINY
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.ops import fused_ce as jax_fused_ce
from orion_tpu.training import data as jax_data
from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
from orion_tpu.training.trainer import lm_loss as jax_lm_loss
from orion_tpu.training.trainer import make_optimizer as jax_make_optimizer
from orion_tpu.training.trainer import make_schedule as jax_make_schedule
from orion_tpu_torch.convert import expected_params, load_jax_params, params_from_jax
from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.models.transformer import TransformerLM
from orion_tpu_torch.ops import fused_ce
from orion_tpu_torch.ops.kernels import causal_dot
from orion_tpu_torch.training import data
from orion_tpu_torch.training.trainer import Optimizer, TrainConfig, lm_loss, make_schedule

torch.set_num_threads(2)


def _close(got, ref, rtol, atol_of_max, name=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_of_max * float(np.abs(ref).max()),
                               err_msg=name)


@pytest.mark.parametrize("b,t,n_chunks", [(2, 16, 2), (1, 20, 4)])
def test_fused_linear_cross_entropy_matches_jax(b, t, n_chunks):
    rng = np.random.default_rng(t)
    d, v = 32, 50
    x = rng.standard_normal((b, t, d), dtype=np.float32)
    w = rng.standard_normal((v, d), dtype=np.float32) * 0.3
    y = rng.integers(0, v, (b, t)).astype(np.int32)
    g = rng.standard_normal((b, t), dtype=np.float32)
    loss_r, vjp = jax.vjp(
        lambda x_, w_: jax_fused_ce.fused_linear_cross_entropy(
            x_, w_, jnp.asarray(y), n_chunks, True),
        jnp.asarray(x), jnp.asarray(w),
    )
    dx_r, dw_r = vjp(jnp.asarray(g))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    loss = fused_ce.fused_linear_cross_entropy(xt, wt, torch.from_numpy(y), n_chunks)
    dx, dw = torch.autograd.grad(loss, (xt, wt), torch.from_numpy(g))
    for name, got, ref in (("loss", loss, loss_r), ("dx", dx, dx_r), ("dw", dw, dw_r)):
        _close(got, ref, 1e-5, 1e-6, name)


def test_chunk_plan_matches_jax():
    for b in (1, 2, 8, 16):
        for t in (1, 7, 100, 256, 1000, 1024, 2047, 4096, 9973, 16384):
            assert fused_ce.pick_n_chunks(b, t) == jax_fused_ce.pick_n_chunks(b, t), (b, t)
            assert fused_ce.chunk_plan(b, t) == jax_fused_ce.chunk_plan(b, t), (b, t)


@functools.lru_cache(maxsize=None)
def _tiny_params(seed):
    """A flax param tree for TINY drawn with numpy (no JAX init to trace)."""
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


_TINY_BATCH = np.random.default_rng(4).integers(0, TINY.vocab_size, (2, 41)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_tiny_loss_and_grads():
    jm = JaxLM(JAX_TINY)
    loss_fn = jax.value_and_grad(lambda p: jax_lm_loss(jm, p, jnp.asarray(_TINY_BATCH)))
    loss, grads = jax.jit(loss_fn)(jax.tree.map(jnp.asarray, _tiny_params(3)))
    return float(loss), params_from_jax(jax.device_get(grads), TINY)


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """The kernel backend's three wrappers, stood in for by their plain
    versions (this machine has no card)."""
    monkeypatch.setattr(causal_dot, "causal_dot_norm_cuda", causal_dot.causal_dot_norm_plain)
    monkeypatch.setattr(causal_dot, "causal_dot_dq_den_cuda", causal_dot.causal_dot_dq_den_plain)
    monkeypatch.setattr(causal_dot, "causal_dot_rev_den_cuda", causal_dot.causal_dot_rev_den_plain)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_tiny_lm_loss_and_grads_match_jax(backend, kernels_as_plain):
    """backend="torch": autograd through the plain chunked form;
    backend="cuda": LinearAttentionFn, whose backward is the backward
    kernels' plain versions here."""
    loss_r, ref = _jax_tiny_loss_and_grads()
    model = load_jax_params(
        TransformerLM(dataclasses.replace(TINY, backend=backend), device="cpu"), _tiny_params(3))
    loss = lm_loss(model, torch.from_numpy(_TINY_BATCH).long())
    loss.backward()
    _close(loss, loss_r, 1e-5, 0.0, "loss")
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, ref[name], 1e-4, 1e-5, name)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 100])
def test_schedules_match_optax(schedule, warmup):
    kw = dict(steps=1000, lr=3e-4, warmup_steps=warmup, min_lr_ratio=0.1, schedule=schedule)
    ours, theirs = make_schedule(TrainConfig(**kw)), jax_make_schedule(JaxTrainConfig(**kw))
    for step in (0, 1, 2, 50, 99, 100, 101, 500, 899, 999, 1000, 1500):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"{schedule} step {step}")
    assert ours(0) == 0.0 or warmup == 0  # optax's count starts at 0


@pytest.mark.parametrize("optimizer,mu_dtype", [("adamw", None), ("adamw", "bfloat16"),
                                                ("lion", None), ("lion", "bfloat16")])
def test_optimizer_steps_match_optax(optimizer, mu_dtype):
    rng = np.random.default_rng(7)
    kw = dict(optimizer=optimizer, mu_dtype=mu_dtype, lr=1e-2, warmup_steps=2, steps=10,
              weight_decay=0.1)
    shapes = {"w": (4, 3), "b": (3,), "e": (5, 2)}
    p0 = {n: rng.standard_normal(s, dtype=np.float32) for n, s in shapes.items()}
    tx = jax_make_optimizer(JaxTrainConfig(**kw), include_clip=False)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    state = tx.init(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    opt = Optimizer(TrainConfig(**kw), tp)
    for step in range(4):
        grads = {n: rng.standard_normal(s, dtype=np.float32) for n, s in shapes.items()}
        updates, state = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(tp, {n: torch.from_numpy(g) for n, g in grads.items()})
        for n in shapes:
            _close(tp[n], jp[n], 1e-6, 1e-7, f"{n} after step {step}")
    assert opt.count == 4


def test_window_starts_and_datasets_bitwise_equal_the_reference(tmp_path):
    for seed, step, b, n in [(0, 0, 8, 1000), (3, 17, 5, 7), (2**40 + 5, 123456, 16, 10**9)]:
        np.testing.assert_array_equal(data.window_starts(seed, step, b, n),
                                      jax_data.window_starts(seed, step, b, n))
    for vocab, t in ((256, 64), (32000, 33)):
        for seed, step in ((0, 0), (1, 5), (7, 1000)):
            np.testing.assert_array_equal(
                data.SyntheticDataset(vocab, t).batch(seed, step, 4),
                jax_data.SyntheticDataset(vocab, t).batch(seed, step, 4))
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"shard_{i}.bin"))
        data.write_token_bin(paths[-1], rng.integers(0, 300, 500 + 100 * i), 300)
    ours = data.make_dataset(paths[0], 32)
    theirs = jax_data.TokenBinDataset(paths[0], 32)
    assert ours.vocab_size == theirs.vocab_size == 300
    np.testing.assert_array_equal(ours.batch(5, 9, 6), theirs.batch(5, 9, 6))
    ours = data.make_dataset(str(tmp_path), 32)
    theirs = jax_data.ShardedTokenBinDataset(paths, 32)
    assert ours.n_windows == theirs.n_windows
    for step in range(3):
        np.testing.assert_array_equal(ours.batch(1, step, 8), theirs.batch(1, step, 8))


def test_trainer_steps_with_a_skipped_nonfinite_step_match_optax():
    """The port's Trainer (fused clip + finite guard + AdamW) against the
    reference's optax chain with clipping, fed the same gradients: step 2's
    gradients are poisoned, so both skip it, and step 3's lr is the
    schedule at the good-step count."""
    from orion_tpu_torch.training.data import SyntheticDataset
    from orion_tpu_torch.training.trainer import Trainer

    kw = dict(lr=1e-2, warmup_steps=2, steps=10, clip_norm=0.5)
    tr = Trainer(TrainConfig(model=TINY, batch_size=2, seq_len=16, **kw), device="cpu")
    tx = jax_make_optimizer(JaxTrainConfig(**kw), include_clip=True)
    jp = {n: jnp.asarray(p.detach().numpy()) for n, p in tr.params.items()}
    state = tx.init(jp)

    @jax.jit
    def apply(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    ds = SyntheticDataset(TINY.vocab_size, 16)
    w = tr.model.final_norm.weight
    for step in range(4):
        batch = torch.from_numpy(ds.batch(0, step, 2)).long()
        poisoned = step == 2
        if poisoned:
            clean = w.detach().clone()
            with torch.no_grad():
                w[0] = float("nan")
        tr._loss_and_grads(batch, step_seed=0)
        grads = {n: jnp.asarray(p.grad.numpy()) for n, p in tr.params.items()}
        m = tr.step(batch)
        assert m["nonfinite"] == float(poisoned)
        if poisoned:  # the reference's guard: params and optimizer state stay
            with torch.no_grad():
                w.copy_(clean)
            continue
        jp, state = apply(grads, state, jp)
        for n, p in tr.params.items():
            _close(p, jp[n], 1e-6, 1e-7, f"{n} after step {step}")
    assert tr.opt.count == 3 and m["lr"] == pytest.approx(tr.sched(2))
