"""The port's LRA classifier and its trainer held against the JAX package's
on the CPU.

Both sides carry the same weights: a flax parameter tree drawn with numpy
from a seed, fed to ``orion_tpu.models.classifier.LRAClassifier`` as it is
and to the port through ``orion_tpu_torch.convert.load_jax_params``. Small
widths (d 32, 2 heads, 2 layers), fp32, GELU, LayerNorm, as the ``lra_*``
configs define them; every batch has rows that the key mask pads.

Tolerances (fp32): logits and loss within 1e-4 relative plus 1e-4 of the
largest magnitude; every gradient within 1e-4 relative plus 1e-5 of its
largest magnitude (the same sums in another order; LayerNorm's fast
variance in another order too). Three training steps: loss and accuracy
within 1e-4, params within 1e-5 relative plus 1e-5 of their largest
magnitude (the same optax formulas over gradients that already differ in
their last bits). Datasets are compared bitwise.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orion_tpu import train_lra as jax_lra
from orion_tpu.models import configs as jax_configs
from orion_tpu.models.classifier import LRAClassifier as JaxClassifier
from orion_tpu.training import trainer as jax_trainer
from orion_tpu_torch import train_lra as lra
from orion_tpu_torch.convert import expected_params, load_jax_params, params_from_jax
from orion_tpu_torch.models.classifier import LRAClassifier
from orion_tpu_torch.models.configs import get_config
from orion_tpu_torch.training.trainer import make_optimizer, make_schedule, param_grads

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_SMALL = dict(d_model=32, n_heads=2, n_layers=2, max_seq_len=64)
_CASES = {  # (config, overrides)
    "linear": ("lra_listops_linear", {}),
    "softmax": ("lra_listops_softmax", {}),
    "linear_favor": ("lra_text_linear", {"feature_map": "favor"}),
}


def _cfgs(case):
    name, over = _CASES[case]
    over = {**_SMALL, **over, "layer_types": (get_config(name).layer_types[0],) * 2}
    return (dataclasses.replace(jax_configs.get_config(name), **over),
            dataclasses.replace(get_config(name), **over))


def _tree(flat):
    tree = {}
    for path, arr in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return {"params": tree}


@functools.lru_cache(maxsize=None)
def _params(case, seed=0):
    """A flax param tree for the small classifier, drawn with numpy: weights
    at the flax init scales, norm scales around 1 and biases around 0 so
    that they matter, a FAVOR+ projection of Gaussian rows."""
    _, cfg = _cfgs(case)
    rng = np.random.default_rng(seed)
    flat = {}
    for path, (_, shape, transpose) in expected_params(cfg, classifier=True).items():
        shape = shape[::-1] if transpose else shape  # flax kernels are [in, out]
        if path.endswith("scale"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif path.endswith("bias"):
            arr = 0.1 * rng.standard_normal(shape)
        elif path.endswith("favor_proj"):
            arr = rng.standard_normal(shape)
        elif len(shape) == 1:  # cls
            arr = 0.02 * rng.standard_normal(shape)
        else:
            arr = rng.standard_normal(shape) / np.sqrt(shape[0] if transpose else shape[1])
        flat[path] = arr.astype(np.float32)
    return _tree(flat)


def _batch(cfg, seed, b=3, t=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, min(cfg.vocab_size, 16), (b, t)).astype(np.int32)
    lengths = np.array([t, t - 7, 5])[:b]  # rows the key mask pads
    mask = np.arange(t)[None, :] < lengths[:, None]
    labels = rng.integers(0, cfg.n_classes, (b,)).astype(np.int32)
    return toks, labels, mask


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)).long() if a.dtype != bool else torch.from_numpy(a)
            for a in arrays]


def _close(got, ref, rtol, atol_of_max, name=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_of_max * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("case", list(_CASES))
def test_classifier_logits_loss_and_grads_match_jax(case):
    jcfg, cfg = _cfgs(case)
    params = _params(case)
    toks, labels, mask = _batch(cfg, 1)
    jm = JaxClassifier(jcfg)

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(toks), jnp.asarray(mask))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    (loss_r, logits_r), grads_r = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    ref = params_from_jax(jax.device_get(grads_r), cfg, classifier=True)

    model = load_jax_params(LRAClassifier(cfg, device="cpu"), params)
    tt, tl, tm = _torch(toks, labels, mask)
    loss, _ = lra.lra_loss(model, tt, tl, tm)
    logits = model(tt, tm)
    loss.backward()
    _close(logits, logits_r, 1e-4, 1e-4, "logits")
    _close(loss, loss_r, 1e-4, 1e-4, "loss")
    grads = param_grads(dict(model.named_parameters()))
    for name, g in grads.items():
        _close(g, ref[name], 1e-4, 1e-5, name)
    if case == "linear_favor":  # stop_gradient: the projection gets zeros on both sides
        assert not any(float(ref[n].abs().max()) for n in grads if n.endswith("favor_proj"))


def test_padding_does_not_reach_the_real_rows():
    """A padded row's logits do not depend on what the pad positions hold."""
    _, cfg = _cfgs("softmax")
    model = load_jax_params(LRAClassifier(cfg, device="cpu"), _params("softmax"))
    toks, _, mask = _batch(cfg, 2)
    other = np.where(mask, toks, (toks + 5) % 16).astype(np.int32)
    with torch.no_grad():
        a = model(*_torch(toks, mask))
        b = model(*_torch(other, mask))
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _lra_cfgs(case, steps=3):
    jcfg, cfg = _cfgs(case)
    common = dict(steps=steps, batch_size=3, seq_len=24, lr=3e-3, warmup_steps=1)
    return (jax_lra.LRATrainConfig(model=jcfg, **common),
            lra.LRATrainConfig(model=cfg, **common))


@pytest.mark.parametrize("case", ["linear", "linear_favor"])
def test_three_lra_steps_match_jax(case):
    jtc, tc = _lra_cfgs(case)
    params = _params(case)
    jm = JaxClassifier(jtc.model)
    shim = jax_trainer.TrainConfig(
        model=jtc.model, steps=jtc.steps, lr=jtc.lr, warmup_steps=jtc.warmup_steps,
        weight_decay=jtc.weight_decay, clip_norm=jtc.clip_norm, schedule=jtc.schedule,
        min_lr_ratio=jtc.min_lr_ratio, optimizer=jtc.optimizer, b1=jtc.b1, b2=jtc.b2,
        eps=jtc.eps, mu_dtype=jtc.mu_dtype)
    tx = jax_trainer.make_optimizer(shim)
    jstep, _ = jax_lra.make_lra_step(jm, tx, jax_trainer.make_schedule(shim),
                                     jax.random.key(0), 0.0)
    p0 = jax.tree.map(jnp.asarray, params)
    state = {"params": p0, "opt": tx.init(p0), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jstep)

    model = load_jax_params(LRAClassifier(tc.model, device="cpu"), params)
    shim_t = lra.lra_shim(tc)
    named = dict(model.named_parameters())
    transposed = {k: t for k, _, t in expected_params(tc.model, classifier=True).values()}
    step_fn, _ = lra.make_lra_step(model, make_optimizer(shim_t, named, transposed),
                                   make_schedule(shim_t), 0, 0.0, tc.clip_norm)
    for i in range(tc.steps):
        toks, labels, mask = _batch(tc.model, 10 + i)
        state, m_r = jstep(state, jnp.asarray(toks), jnp.asarray(labels), jnp.asarray(mask))
        m = step_fn(i, *_torch(toks, labels, mask))
        for key in ("loss", "acc"):
            assert abs(m[key] - float(m_r[key])) <= 1e-4, (i, key, m[key], float(m_r[key]))
        assert m["lr"] == pytest.approx(float(m_r["lr"]), rel=1e-6)
        assert m["nonfinite"] == float(m_r["nonfinite"]) == 0.0
    ref = params_from_jax(jax.device_get(state["params"]), tc.model, classifier=True)
    for name, p in model.named_parameters():
        _close(p, ref[name], 1e-5, 1e-5, name)
        if name.endswith("favor_proj"):  # neither decayed nor moved
            assert torch.equal(p, load_jax_params(
                LRAClassifier(tc.model, device="cpu"), params).state_dict()[name])


@pytest.mark.parametrize("seq_len", [3, 5, 37, 200])
def test_synthetic_datasets_bitwise_equal_the_reference(seq_len):
    for ours, ref in ((lra.SyntheticListOps, jax_lra.SyntheticListOps),
                      (lra.SyntheticText, jax_lra.SyntheticText)):
        assert (ours.vocab_size, ours.n_classes) == (ref.vocab_size, ref.n_classes)
        for seed, step in ((0, 0), (3, 17)):
            for a, b in zip(ours(seq_len).batch(seed, step, 4), ref(seq_len).batch(seed, step, 4)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["ids", "bytes"])
def test_tsv_dataset_bitwise_equals_the_reference(tmp_path, mode):
    path = tmp_path / "train.tsv"
    rows = (["3\t10 1 2 3 12 9", "0\t11 4 5 12", "7\t" + " ".join(["5"] * 40)] if mode == "ids"
            else ["1\thello world", "0\tune phrase accentuée", "1\t" + "x" * 50])
    path.write_text("\n".join(rows) + "\n")
    ours = lra.TSVDataset(str(path), 32, mode, 10, 256)
    ref = jax_lra.TSVDataset(str(path), 32, mode, 10, 256)
    assert ours.samples == ref.samples
    for a, b in zip(ours.batch(1, 2, 5), ref.batch(1, 2, 5)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_make_lra_dataset_picks_the_reference_dataset(tmp_path):
    (tmp_path / "train.tsv").write_text("1\t1 2 3\n0\t4 5\n")
    (tmp_path / "val.tsv").write_text("0\t4 4\n")
    for task in ("listops", "text", str(tmp_path)):
        for split in ("train", "val") if task == str(tmp_path) else ("train",):
            jtc = jax_lra.LRATrainConfig(task=task, seq_len=16)
            tc = lra.LRATrainConfig(task=task, seq_len=16)
            a = lra.make_lra_dataset(tc, split).batch(0, 1, 3)
            b = jax_lra.make_lra_dataset(jtc, split).batch(0, 1, 3)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [f.name for f in dataclasses.fields(lra.LRATrainConfig)] == \
        [f.name for f in dataclasses.fields(jax_lra.LRATrainConfig)]


def test_train_lra_on_a_tsv_directory_and_the_cli(tmp_path):
    rows = [f"{i % 10}\t" + " ".join(str((i + j) % 10) for j in range(3 + i % 9))
            for i in range(20)]
    for split in ("train", "val"):
        (tmp_path / f"{split}.tsv").write_text("\n".join(rows) + "\n")
    cfg = dataclasses.replace(get_config("lra_listops_linear"), **_SMALL,
                              layer_types=("linear",) * 2)
    params, last = lra.train_lra(
        lra.LRATrainConfig(model=cfg, task=str(tmp_path), steps=2, batch_size=4, seq_len=12,
                           eval_batches=2), device="cpu")
    assert set(last) >= {"loss", "acc", "grad_norm", "lr", "nonfinite", "eval_acc"}
    assert np.isfinite(last["loss"]) and 0.0 <= last["eval_acc"] <= 1.0
    assert all(torch.isfinite(p).all() for p in params.values())
    proc = subprocess.run(
        [sys.executable, "-m", "orion_tpu_torch.train_lra", "--config", "lra_text_softmax",
         "--task", "text", "--steps", "2", "--batch-size", "2", "--seq-len", "16",
         "--device", "cpu", "--set", "d_model=32", "--set", "n_heads=2"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "'eval_acc'" in proc.stdout.strip().splitlines()[-1]


def test_a_mesh_raises():
    from orion_tpu_torch.training.trainer import MeshConfig

    with pytest.raises(NotImplementedError, match="item 12"):
        lra.train_lra(lra.LRATrainConfig(mesh=MeshConfig(dp=2), steps=1), device="cpu")
