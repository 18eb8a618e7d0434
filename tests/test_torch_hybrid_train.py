"""The port's hybrid model trained on the CPU: one batch's loss and every
gradient against ``jax.value_and_grad`` of the JAX package's, and
``hybrid_1b3`` (shrunk in width) through both CLIs.

The tiny hybrid of ``tests/test_torch_hybrid.py`` (4 layers of types swa,
swa, softmax, linear, window 16, fp32), with the same numpy-drawn weights
on both sides. For the kernel backend the plain versions stand in for the
six kernels of the training path (this machine has no card). Tolerances, as
``tests/test_torch_training.py``: the loss to 1e-5 relative and every
gradient to 1e-4 relative plus 1e-5 of its largest magnitude (fp32 sums in
another order, through the softmax and the linear layer's normalizer).
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

from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.training.trainer import lm_loss as jax_lm_loss
from orion_tpu_torch.convert import load_jax_params, params_from_jax
from orion_tpu_torch.models.transformer import TransformerLM
from orion_tpu_torch.ops.kernels import causal_dot
from orion_tpu_torch.ops.kernels import flash_attention as fa
from orion_tpu_torch.training.trainer import lm_loss
from test_torch_hybrid import CFG, JAX_CFG, _tree

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


_BATCH = np.random.default_rng(7).integers(0, 256, (2, 41)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    jm = JaxLM(dataclasses.replace(JAX_CFG, backend="xla"))
    loss_fn = jax.value_and_grad(lambda p: jax_lm_loss(jm, p, jnp.asarray(_BATCH)))
    loss, grads = jax.jit(loss_fn)(jax.tree.map(jnp.asarray, _tree(0)))
    return float(loss), params_from_jax(jax.device_get(grads), CFG)


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """The training path's six kernel wrappers, stood in for by their plain
    versions."""
    for mod, name, plain in [
        (causal_dot, "causal_dot_norm_cuda", causal_dot.causal_dot_norm_plain),
        (causal_dot, "causal_dot_dq_den_cuda", causal_dot.causal_dot_dq_den_plain),
        (causal_dot, "causal_dot_rev_den_cuda", causal_dot.causal_dot_rev_den_plain),
        (fa, "flash_fwd_cuda", fa.flash_fwd_plain),
        (fa, "flash_dq_cuda", fa.flash_dq_plain),
        (fa, "flash_dkv_cuda", fa.flash_dkv_plain),
    ]:
        monkeypatch.setattr(mod, name, plain)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_loss_and_grads_match_jax(backend, kernels_as_plain):
    """backend="torch": autograd through the plain forms; backend="cuda":
    ``FlashAttentionFn`` and ``LinearAttentionFn``, with remat over the
    first two blocks, their kernels' plain versions standing in."""
    loss_r, ref = _jax_loss_and_grads()
    cfg = dataclasses.replace(CFG, backend=backend, remat=backend == "cuda", remat_skip=2)
    model = load_jax_params(TransformerLM(cfg, device="cpu"), _tree(0))
    loss = lm_loss(model, torch.from_numpy(_BATCH).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss_r, rtol=1e-5)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        g, r = p.grad.numpy(), ref[name].numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * float(np.abs(r).max()), err_msg=name)


_SHRINK = {"d_model": 128, "n_heads": 4, "window": 16, "max_seq_len": 256}


def test_hybrid_generate_cli_runs_on_the_cpu():
    """``hybrid_1b3`` shrunk in width (its 24 layers and their types kept)."""
    shrink = [a for k, v in _SHRINK.items() for a in ("--set", f"{k}={v}")]
    cmd = [sys.executable, "-m", "orion_tpu_torch.generate", "--config", "hybrid_1b3", *shrink,
           "--device", "cpu", "--temperature", "0", "--max-new-tokens", "8"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("Hello")


def test_hybrid_train_cli_runs_on_the_cpu():
    shrink = [a for k, v in _SHRINK.items() for a in ("--set", f"model.{k}={v}")]
    cmd = [sys.executable, "-m", "orion_tpu_torch.train", "--config", "hybrid_1b3", *shrink,
           "--seq-len", "32", "--batch-size", "1", "--steps", "2", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "loss" in proc.stdout
