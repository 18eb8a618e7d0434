"""The port's Trainer with ``optimizer="adafactor"`` and ``"adafactor_fused"``
held against the JAX package's Trainer, on the CPU, and its resume.

``TINY`` (max_seq_len 64) from one numpy-drawn flax tree in both; the same
synthetic batches; 3 steps, each with the fused clip + finite guard. The JAX
Trainer runs optax's adafactor, or its fused form (on the CPU, its plain
formulas); the port runs the plain formulas, or the kernel form with every
factored leaf sent through the three passes (``_MIN_KERNEL_ELEMS`` lowered;
on CPU tensors each pass is its plain version). Tolerances: losses to 1e-5
relative (fp32 forward and backward in another order, as
``tests/test_torch_training.py``); params to 1e-5 relative plus 1e-6
absolute, since Adafactor normalizes each update (about lr in size) by the
gradient's own statistics, which carry the gradients' 1e-4-relative
cross-framework differences into the update's last digits. A resumed
fused run is bitwise the uninterrupted one, statistics included.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.models.configs import TINY as JAX_TINY
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
from orion_tpu.training.trainer import Trainer as JaxTrainer
from orion_tpu_torch.convert import expected_params, load_jax_params, params_from_jax
from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.ops.kernels import adafactor as af
from orion_tpu_torch.train import train
from orion_tpu_torch.training.data import SyntheticDataset
from orion_tpu_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(2)
MODEL = dataclasses.replace(TINY, max_seq_len=64)
KW = dict(steps=4, batch_size=2, seq_len=64, lr=1e-3, warmup_steps=2, log_every=10**9)


@functools.lru_cache(maxsize=None)
def _tree():
    rng = np.random.default_rng(11)
    tree = {}
    for path, (_, shape, transpose) in expected_params(MODEL).items():
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


def _batches(n):
    ds = SyntheticDataset(MODEL.vocab_size, 64)
    return [ds.batch(0, i, 2) for i in range(n)]


@pytest.mark.parametrize("optimizer", ["adafactor", "adafactor_fused"])
def test_trainer_matches_the_jax_trainer(optimizer, monkeypatch):
    monkeypatch.setattr(af, "_MIN_KERNEL_ELEMS", 0)
    jtr = JaxTrainer(JaxTrainConfig(model=dataclasses.replace(JAX_TINY, max_seq_len=64),
                                    optimizer=optimizer, mesh=JaxMeshConfig(dp=1), **KW))
    params = jax.tree.map(jnp.asarray, _tree())
    jtr.state = jtr.state.replace(params=params, opt_state=jtr.tx.init(params))
    tr = Trainer(TrainConfig(model=MODEL, optimizer=optimizer, **KW), device="cpu")
    load_jax_params(tr.model, _tree())
    before = af.launches_sums
    for b in _batches(3):
        want = float(jtr.step(jnp.asarray(b))["loss"])
        got = tr.step(torch.from_numpy(b).long())["loss"]
        assert got == pytest.approx(want, rel=1e-5)
    assert af.launches_sums == before  # CPU tensors: the plain versions
    ref = params_from_jax(jax.device_get(jtr.state.params), MODEL)
    for n, p in tr.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    assert tr.opt.count == 3


@pytest.mark.parametrize("optimizer", ["adafactor", "adafactor_fused"])
def test_a_nonfinite_trainer_step_leaves_params_and_state_bitwise(optimizer, monkeypatch):
    """A NaN gradient: the step is counted as skipped, and params, v_row /
    v_col / v and the optimizer's count stay as they were (the fused form
    queues its update before the host reads the finite flag)."""
    monkeypatch.setattr(af, "_MIN_KERNEL_ELEMS", 0)
    tr = Trainer(TrainConfig(model=MODEL, optimizer=optimizer, **KW), device="cpu")
    load_jax_params(tr.model, _tree())
    b0, b1 = (torch.from_numpy(b).long() for b in _batches(2))
    tr.step(b0)
    params = {n: p.detach().clone() for n, p in tr.params.items()}
    state = {k: {n: t.clone() for n, t in getattr(tr.opt.state, k).items()}
             for k in ("v_row", "v_col", "v")}
    real = tr._loss_and_grads

    def poisoned(batch, rng):
        loss = real(batch, rng)
        tr.params["embed.weight"].grad[0, 0] = float("nan")
        return loss

    monkeypatch.setattr(tr, "_loss_and_grads", poisoned)
    metrics = tr.step(b1)
    assert metrics["nonfinite"] == 1.0 and tr.nonfinite == 1 and tr.opt.count == 1
    for n, p in tr.params.items():
        assert torch.equal(p, params[n]), n
    for key, leaves in state.items():
        for n, t in leaves.items():
            assert torch.equal(getattr(tr.opt.state, key)[n], t), (key, n)


def test_fused_resume_is_bitwise_equal_to_an_uninterrupted_run(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(af, "_MIN_KERNEL_ELEMS", 0)
    cfg = TrainConfig(model=MODEL, optimizer="adafactor_fused", ckpt_every=2,
                      **{**KW, "log_every": 1})
    full, _ = train(dataclasses.replace(cfg, ckpt_dir=str(tmp_path / "a")), device="cpu")
    half = dataclasses.replace(cfg, ckpt_dir=str(tmp_path / "b"))
    train(dataclasses.replace(half, steps=2), device="cpu")
    resumed, _ = train(half, device="cpu")
    assert "resumed from step 2" in capsys.readouterr().err
    assert resumed.step_count == full.step_count == 4 and resumed.opt.count == 4
    for n, p in full.params.items():
        assert torch.equal(resumed.params[n], p), n
    for key in ("v_row", "v_col", "v"):
        for n, t in getattr(full.opt.state, key).items():
            assert torch.equal(getattr(resumed.opt.state, key)[n], t), (key, n)
