"""The port's MoE model trained on the CPU: one batch's loss (with the MoE
auxiliary loss) and every gradient against ``jax.value_and_grad`` of the
JAX package's ``lm_loss``, and ``moe_1b3_4e`` (shrunk in width) through the
train CLI.

The tiny MoE of ``tests/test_torch_moe_model.py`` in its four variants, on a
batch of 4 x 256 tokens: 1024 routed rows at top-1, the tile-aligned form's
threshold. backend="torch": autograd through the plain forms (the ragged
form for dropless). backend="cuda": remat over both blocks, the
attention kernels' and the gmm kernels' plain versions standing in, and the
dropless layer taking the tile-aligned form (``GmmFn``) as on the card. The
JAX side runs its XLA forms (dropless: the ragged_dot form). Tolerances, as
``tests/test_torch_training.py``: the loss to 1e-5 relative and every
gradient to 1e-4 relative plus 1e-5 of its largest magnitude, with the
router's floor of ``tests/test_torch_moe.py`` (2e-5: at top-1 the gates are
g / g, whose gradient vanishes in exact arithmetic).
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
from orion_tpu_torch.convert import params_from_jax
from orion_tpu_torch.evaluate import lm_eval_sums
from orion_tpu_torch.models import moe
from orion_tpu_torch.ops.kernels import causal_dot
from orion_tpu_torch.ops.kernels import gmm as gm
from orion_tpu_torch.training.trainer import lm_loss
from test_torch_moe_model import VARIANTS, cfgs, model, tree

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
GRAD_FLOOR = 2e-5

_BATCH = np.random.default_rng(7).integers(0, 256, (4, 257)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(variant):
    cfg, jcfg = cfgs(variant)
    jm = JaxLM(jcfg)
    loss_fn = jax.value_and_grad(lambda p: jax_lm_loss(jm, p, jnp.asarray(_BATCH)))
    loss, grads = jax.jit(loss_fn)(jax.tree.map(jnp.asarray, tree()))
    return float(loss), params_from_jax(jax.device_get(grads), cfg)


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """The training path's kernels stood in for by their plain versions, and
    the backend resolved as on the card, so the dropless layer takes the
    tile-aligned form and GmmFn."""
    for mod, name, plain in [
        (causal_dot, "causal_dot_norm_cuda", causal_dot.causal_dot_norm_plain),
        (causal_dot, "causal_dot_dq_den_cuda", causal_dot.causal_dot_dq_den_plain),
        (causal_dot, "causal_dot_rev_den_cuda", causal_dot.causal_dot_rev_den_plain),
        (gm, "gmm_cuda", gm.gmm_torch),
        (gm, "gmm_dw_cuda", gm.gmm_dw_torch),
    ]:
        monkeypatch.setattr(mod, name, plain)
    taken = []
    real = moe.MoEMLP._dropless_gmm
    monkeypatch.setattr(moe.MoEMLP, "_dropless_gmm",
                        lambda self, *a: (taken.append(1), real(self, *a))[1])
    monkeypatch.setattr(moe, "resolve", lambda backend, device: backend)
    monkeypatch.setattr(gm, "resolve", lambda backend, device: backend)
    return taken


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_and_grads_match_jax(variant, backend, kernels_as_plain):
    loss_r, ref = _jax_loss_and_grads(variant)
    m = model(variant, backend)
    m.cfg = dataclasses.replace(m.cfg, remat=backend == "cuda", remat_skip=0)
    loss = lm_loss(m, torch.from_numpy(_BATCH).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss_r, rtol=1e-5)
    for name, p in m.named_parameters():
        assert p.grad is not None, name
        g, r = p.grad.numpy(), ref[name].numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=GRAD_FLOOR + 1e-5 * float(np.abs(r).max()),
                                   err_msg=name)
    # the tile-aligned form ran in the forward and in the recomputation
    gmm_form = backend == "cuda" and cfgs(variant)[0].moe_dropless
    assert len(kernels_as_plain) == (2 if gmm_form else 0)


def test_eval_loss_leaves_the_aux_loss_out():
    """The training loss is the eval loss (mean token cross entropy) plus
    the MoE layers' auxiliary loss, as in the JAX package."""
    m = model("top2-dropless")
    batch = torch.from_numpy(_BATCH).long()
    with torch.no_grad():
        total, count = lm_eval_sums(m, batch)
        train = lm_loss(m, batch)
        _, aux = m.features(batch[:, :-1])
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(train), float(total / count) + float(aux), rtol=1e-6)


def test_moe_train_cli_runs_on_the_cpu():
    shrink = {"d_model": 128, "n_heads": 4, "max_seq_len": 256, "moe_dropless": "true"}
    args = [a for k, v in shrink.items() for a in ("--set", f"model.{k}={v}")]
    cmd = [sys.executable, "-m", "orion_tpu_torch.train", "--config", "moe_1b3_4e", *args,
           "--seq-len", "32", "--batch-size", "2", "--steps", "2", "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "loss" in proc.stdout
