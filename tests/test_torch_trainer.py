"""The port's trainer on the CPU: what it promises within the port.

Gradient accumulation's loss and gradients equal the full batch's (fp32
sums in another order: 1e-6 relative plus 1e-6 of the largest magnitude;
the params after Adam are not compared, since Adam divides near-zero
gradients by their own size and so magnifies that noise); a non-finite step leaves
params and optimizer state exactly as they were and the lr follows the
good-step count; a resumed run, a rematerialized model and a rerun with the
same dropout seed are bitwise equal to the uninterrupted, plain or first
run; checkpoints verify and fall back; the CLI trains; what is not ported
raises.
"""

import copy
import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from orion_tpu_torch.models.configs import TINY
from orion_tpu_torch.models.transformer import TransformerLM
from orion_tpu_torch.train import train
from orion_tpu_torch.training.checkpoint import CheckpointIntegrityError, Checkpointer
from orion_tpu_torch.training.data import SyntheticDataset
from orion_tpu_torch.training.trainer import MeshConfig, TrainConfig, Trainer, lm_loss

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _cfg(**kw):
    base = dict(model=TINY, steps=4, batch_size=4, seq_len=32, warmup_steps=2, lr=1e-2,
                log_every=1)
    base.update(kw)
    return TrainConfig(**base)


def _batches(cfg, n, seed=0):
    ds = SyntheticDataset(cfg.model.vocab_size, cfg.seq_len)
    return [torch.from_numpy(ds.batch(seed, i, cfg.batch_size)).long() for i in range(n)]


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.params.items()}


def test_accum_steps_2_equals_the_full_batch():
    b = _batches(_cfg(), 1)[0]
    got = {}
    for accum in (1, 2):
        tr = Trainer(_cfg(accum_steps=accum), device="cpu")
        loss = tr._loss_and_grads(b, step_seed=0)
        got[accum] = (float(loss), {n: p.grad.clone() for n, p in tr.params.items()})
    assert got[2][0] == pytest.approx(got[1][0], rel=1e-6)
    for n, ref in got[1][1].items():
        torch.testing.assert_close(got[2][1][n], ref, rtol=1e-6,
                                   atol=1e-6 * float(ref.abs().max()))


def test_a_nonfinite_step_is_skipped():
    cfg = _cfg()
    b1, b2, b3 = _batches(cfg, 3)
    tr = Trainer(cfg, device="cpu")
    tr.step(b1)
    tr.step(b1)
    before, opt_before = _params(tr), copy.deepcopy(tr.opt.state_dict())
    w = tr.model.final_norm.weight
    with torch.no_grad():
        w[0] = float("nan")  # a poisoned leaf: the loss and the grads go NaN
    m = tr.step(b2)
    assert m["nonfinite"] == 1.0 and m["nonfinite_total"] == 1.0
    assert not np.isfinite(m["loss"])
    with torch.no_grad():
        w[0] = before["final_norm.weight"][0]
    for n, p in tr.params.items():
        assert torch.equal(p, before[n]), n
    assert tr.opt.count == 2 and tr.step_count == 3
    for n, t in opt_before["mu"].items():
        assert torch.equal(tr.opt.mu[n], t), n
    m3 = tr.step(b3)
    assert m3["lr"] == tr.sched(2)  # the good-step count, step - nonfinite
    ref = Trainer(cfg, device="cpu")  # the same run without the bad step
    for b in (b1, b1, b3):
        ref.step(b)
    for n, p in tr.params.items():
        assert torch.equal(p, ref.params[n]), n


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(tmp_path, capsys):
    model = dataclasses.replace(TINY, dropout=0.1)  # the per-step dropout seeds resume too
    cfg = _cfg(model=model, ckpt_every=2)
    full, _ = train(dataclasses.replace(cfg, ckpt_dir=str(tmp_path / "a")), device="cpu")
    half = dataclasses.replace(cfg, ckpt_dir=str(tmp_path / "b"))
    train(dataclasses.replace(half, steps=2), device="cpu")
    resumed, _ = train(half, device="cpu")
    assert "resumed from step 2" in capsys.readouterr().err
    assert resumed.step_count == full.step_count == 4
    for n, p in full.params.items():
        assert torch.equal(resumed.params[n], p), n
    for n, t in full.opt.mu.items():
        assert torch.equal(resumed.opt.mu[n], t) and torch.equal(resumed.opt.nu[n], full.opt.nu[n])


def test_remat_and_dropout_seeds_reproduce_the_gradients():
    b = _batches(_cfg(), 1)[0]
    grads = []
    for remat, skip in ((False, 0), (True, 1), (True, 0)):
        m = dataclasses.replace(TINY, dropout=0.2, remat=remat, remat_skip=skip)
        model = TransformerLM(m, device="cpu", generator=torch.Generator().manual_seed(5))
        lm_loss(model, b, dropout_seed=123).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for g in grads[1:]:
        for n, ref in grads[0].items():
            assert torch.equal(g[n], ref), n
    model.zero_grad()
    lm_loss(model, b, dropout_seed=124).backward()  # another seed, other masks
    assert not torch.equal(model.embed.weight.grad, grads[2]["embed.weight"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_head_and_cross_entropy_equal_the_unfused(dtype):
    """The fused chunked head + CE against logits through the model's head
    (the tied table cast to the compute dtype, differentiably): fp32 to
    1e-5; bf16 to 1e-2 relative L2 on the table's gradient, since the fused
    backward rounds softmax - onehot to bf16 before its products, as the
    reference does."""
    model = TransformerLM(dataclasses.replace(TINY, dtype=dtype), device="cpu")
    b = _batches(_cfg(), 1)[0]
    out = {}
    for fused in (True, False):
        model.zero_grad()
        loss = lm_loss(model, b, fused_ce=fused)
        loss.backward()
        out[fused] = (float(loss.detach()), model.embed.weight.grad.clone())
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-5)
    g, ref = out[True][1], out[False][1]
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert float((g - ref).norm() / ref.norm()) <= tol


def test_evaluate_is_the_training_loss_without_dropout():
    cfg = _cfg()
    tr = Trainer(cfg, device="cpu")
    b = _batches(cfg, 1)[0]
    ev = tr.evaluate(iter([b]), n_batches=1)
    with torch.no_grad():
        assert ev["eval_loss"] == pytest.approx(float(lm_loss(tr.model, b)), rel=1e-6)


def test_checkpoints_verify_and_fall_back(tmp_path):
    cfg = _cfg()
    tr = Trainer(cfg, device="cpu")
    ck = Checkpointer(str(tmp_path), max_to_keep=2, save_every=1)
    for step, b in enumerate(_batches(cfg, 3), 1):
        tr.step(b)
        assert ck.maybe_save(step, tr.state_dict())
    assert ck.all_steps() == [2, 3]  # retention
    assert not ck.maybe_save(3, tr.state_dict(), force=True)  # already on disk
    assert int(ck.restore()["step"]) == 3
    latest = tmp_path / "step-00000003.pt"
    latest.write_bytes(latest.read_bytes()[:-100])  # a torn write
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert int(ck.restore()["step"]) == 2
    assert any("step 3 is corrupt" in str(w.message) for w in caught)
    with pytest.raises(Exception):
        ck.restore(step=3)  # a pinned step never falls back
    older = torch.load(tmp_path / "step-00000002.pt", weights_only=True)
    older["params"]["final_norm.weight"] += 1.0  # loads fine, fails its checksum
    torch.save(older, tmp_path / "step-00000002.pt")
    with pytest.raises(CheckpointIntegrityError, match="checksum"):
        ck.restore(step=2)


def test_train_cli_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "orion_tpu_torch.train", "--config", "tiny", "--steps", "3",
         "--device", "cpu", "--set", "log_every=1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [line.split()[1] for line in lines[:3]] == ["1", "2", "3"]
    assert "'loss'" in lines[-1] and "'nonfinite_total': 0.0" in lines[-1]


def test_what_is_not_ported_raises():
    # the ep axis is not ported; tp (ported, tests/test_torch_tp*.py), pp
    # (tests/test_torch_pp*.py) and dp (tests/test_torch_dp*.py) need their
    # process group
    with pytest.raises(ValueError, match="init_distributed"):
        Trainer(_cfg(mesh=MeshConfig(dp=1, tp=2)), device="cpu")
    with pytest.raises(ValueError, match="init_distributed"):
        Trainer(_cfg(mesh=MeshConfig(dp=1, pp=2)), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        Trainer(_cfg(mesh=MeshConfig(dp=1, ep=2)), device="cpu")
    with pytest.raises(ValueError, match="init_distributed"):
        Trainer(_cfg(mesh=MeshConfig(dp=2)), device="cpu")
    # bf16 storage with stochastic rounding is ported
    # (tests/test_torch_model_options.py): only an unknown storage raises
    with pytest.raises(ValueError, match="param_storage"):
        Trainer(_cfg(param_storage="float16"), device="cpu")
    # Adafactor is ported (tests/test_torch_adafactor*.py): only an unknown
    # optimizer raises
    with pytest.raises(ValueError, match="unknown optimizer"):
        Trainer(_cfg(optimizer="sgd"), device="cpu")
    # remat_policy="dots" is ported (tests/test_torch_model_options.py): only
    # an unknown policy raises
    with pytest.raises(ValueError, match="remat_policy"):
        TransformerLM(dataclasses.replace(TINY, remat=True, remat_policy="offload"),
                      device="cpu")
    model = TransformerLM(dataclasses.replace(TINY, remat=True, remat_policy="dots"),
                          device="cpu")
    lm_loss(model, _batches(_cfg(), 1)[0]).backward()
    with torch.no_grad():  # nothing is rematerialized without a gradient
        lm_loss(model, _batches(_cfg(), 1)[0])
