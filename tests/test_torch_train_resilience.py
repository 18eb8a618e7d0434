"""The port's training half of the resilience layer on the CPU, held against
the JAX package's (``tests/test_resilience.py`` :232-660):

- fault plans: the training sites' addressing, ``nan_armed``, and every
  registered site of the port covered by a chaos test (the meta-test);
- checkpoints: a save that fails twice lands after two "retrying" warnings
  and an emergency re-save of a saved step is a no-op; a corrupt or
  truncated newest step falls back; a step that failed verification is
  overwritten by the next save there (C7); a pinned step never falls back;
- the real ``train()`` path: a SIGTERM at step 3 (``preempt_at``) stops at
  that boundary with an off-cadence emergency checkpoint, and the resumed
  run is bitwise the uninterrupted one (params and AdamW moments); the JAX
  ``train()`` from the same numpy weights stops at the same step with the
  same deliveries, and the two resumed runs' params agree to 1e-5 relative
  and 1e-6 absolute (the Trainer-against-JAX-Trainer tolerance of
  ``tests/test_torch_adafactor_train.py``: the same fp32 formulas, sums in
  another order); NaN poisoning under ``skip`` and ``halt``; the
  ``ckpt.save`` retry through ``train()``;
- the OOM fallback: a forward that raises ``torch.cuda.OutOfMemoryError``
  once at ``remat_skip=1`` is retried at 0, bitwise a ``remat_skip=0``
  trainer's step (``tests/test_training.py:382``).

The CLI's knobs and a real SIGTERM to it are
``tests/test_torch_train_resilience_cli.py``; the 2-rank gloo mesh's
preemption is ``tests/test_torch_train_resilience_mesh.py``.
"""

import dataclasses
import functools
import os
import shutil
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu import train as jax_train_mod
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from orion_tpu.resilience import inject as jax_inject
from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
from orion_tpu.training.trainer import Trainer as JaxTrainer
from orion_tpu_torch import train as train_mod
from orion_tpu_torch.convert import expected_params, load_jax_params, params_from_jax
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.resilience import inject
from orion_tpu_torch.resilience.retry import RetryPolicy
from orion_tpu_torch.training.checkpoint import Checkpointer, step_path
from orion_tpu_torch.training.data import SyntheticDataset
from orion_tpu_torch.training.trainer import TrainConfig, Trainer

pytestmark = pytest.mark.chaos
torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

# the JAX chaos suite's model
TINY = ModelConfig(name="chaos_tiny", vocab_size=32, d_model=16, n_layers=1, n_heads=2,
                   max_seq_len=32, dtype="float32")
JAX_TINY = JaxModelConfig(name="chaos_tiny", vocab_size=32, d_model=16, n_layers=1, n_heads=2,
                          max_seq_len=32, dtype="float32", backend="xla")
FAST_RETRY = RetryPolicy(attempts=4, base_delay=0.01, max_delay=0.05)
KW = dict(steps=6, batch_size=2, seq_len=16, lr=1e-3, warmup_steps=2, log_every=1,
          ckpt_every=2, preempt_grace=30.0)


def tiny_cfg(ckpt_dir=None, **kw) -> TrainConfig:
    return TrainConfig(**{"model": TINY, "ckpt_dir": ckpt_dir, **KW, **kw})


@functools.lru_cache(maxsize=None)
def _tree(n_layers=1):
    """TINY's weights (at ``n_layers``) drawn with numpy, as a flax tree
    (both packages load it)."""
    rng = np.random.default_rng(5)
    tree = {}
    for path, (_, shape, transpose) in expected_params(
            dataclasses.replace(TINY, n_layers=n_layers)).items():
        shape = shape[::-1] if transpose else shape  # flax kernels are [in, out]
        arr = (1.0 + 0.1 * rng.standard_normal(shape) if path.endswith("scale")
               else rng.standard_normal(shape) / np.sqrt(shape[0] if transpose else shape[1]))
        node = tree
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": tree}


class SeededTrainer(Trainer):
    """The port's Trainer starting from ``_tree()``'s weights."""

    def __init__(self, cfg, device=None, mesh=None):
        super().__init__(cfg, device=device, mesh=mesh)
        load_jax_params(self.model, _tree(cfg.model.n_layers))


class SeededJaxTrainer(JaxTrainer):
    """The JAX package's Trainer starting from the same weights."""

    def __init__(self, cfg, *a, **kw):
        super().__init__(cfg, *a, **kw)
        params = jax.tree.map(jnp.asarray, _tree())
        self.state = self.state.replace(params=params, opt_state=self.tx.init(params))


def _state(trainer):
    return {n: t.detach().clone() for n, t in trainer.params.items()}, {
        k: {n: t.clone() for n, t in v.items()} for k, v in trainer.opt.state_dict().items()
        if isinstance(v, dict)}


def _equal(a, b):
    for n in a:
        assert torch.equal(a[n], b[n]), n


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------


def test_fault_plan_addressing_of_the_training_sites():
    inject.fire("ckpt.save", step=1)  # no plan armed: inert
    plan = inject.FaultPlan().fail_io("ckpt.save", step=2, times=2)
    plan.poison_nan_at(3)
    with inject.inject(plan):
        inject.fire("ckpt.save", step=1)  # another step: no delivery
        for _ in range(2):
            with pytest.raises(OSError):
                inject.fire("ckpt.save", step=2)
        inject.fire("ckpt.save", step=2)  # times=2 spent
        inject.fire("ckpt.restore", step=2)  # another site
        assert not inject.nan_armed(2)
        assert inject.nan_armed(3)
        assert not inject.nan_armed(3)  # consumed
    inject.fire("ckpt.save", step=2)  # disarmed on exit
    assert plan.delivered == ["ckpt.save@2", "ckpt.save@2", "train.nan@3"]
    with pytest.raises(ValueError, match="unknown fault-injection site"):
        inject.FaultPlan().add("train.stepboundary")


# a FaultPlan helper arms its site without naming it
_ARMED_BY = {"train.step_boundary": "preempt_at(", "train.nan": "poison_nan_at(",
             "serve.chunk": "preempt_at_chunk(", "serve.chunk_delay": "delay_chunk(",
             "decode.state_nan": "poison_decode_state_at(",
             "decode.slot_nan.": "poison_decode_slot_at("}


def test_every_registered_chaos_site_is_exercised():
    """Every site the port registers (and every site family) is armed by at
    least one of the port's test modules that arms faults: by its name or
    by the FaultPlan helper that arms it. A hook added without a test that
    drives it fails here."""
    corpus = {p.name: p.read_text() for p in sorted(ROOT.glob("tests/test_torch_*.py"))}
    corpus = {name: text for name, text in corpus.items() if "FaultPlan()" in text}
    for site in list(inject.SITES) + list(inject.SITE_PREFIXES):
        needles = (f'"{site}', _ARMED_BY.get(site, f'"{site}'))
        hits = [name for name, text in corpus.items() if any(n in text for n in needles)]
        assert hits, f"fault site {site!r} is registered but no chaos test arms it"


def test_the_training_sites_are_the_jax_packages():
    """The port registers every site of the JAX package but the executable
    store's (``serve.exec_*``: A13)."""
    theirs = {s for s in jax_inject.SITES if not s.startswith("serve.exec_")}
    assert set(inject.SITES) == theirs
    assert inject.SITE_PREFIXES == jax_inject.SITE_PREFIXES


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_save_retries_injected_io_and_is_idempotent(tmp_path):
    trainer = SeededTrainer(tiny_cfg(), device="cpu")
    ck = Checkpointer(str(tmp_path / "ck"), save_every=10_000, retry=FAST_RETRY)
    plan = inject.FaultPlan().fail_io("ckpt.save", times=2)
    with inject.inject(plan), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert ck.maybe_save(1, trainer.state_dict(), force=True)
    assert sum("retrying" in str(x.message) for x in w) == 2
    assert plan.delivered == ["ckpt.save@1"] * 2
    # an emergency re-save of a saved step is a no-op
    assert not ck.maybe_save(1, trainer.state_dict(), force=True)
    plan = inject.FaultPlan().fail_io("ckpt.restore", step=1)
    with inject.inject(plan), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        restored = ck.restore(step=1)  # verified against its manifest
    assert plan.delivered == ["ckpt.restore@1"]
    _equal(restored["params"], _state(trainer)[0])


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """One 4-step run with saves at steps 2 and 4, copied by each test."""
    d = str(tmp_path_factory.mktemp("base") / "ck")
    _quiet(train_mod.train, tiny_cfg(d, steps=4), data="synthetic", resume=False, device="cpu")
    return d


def _resume_batches(cfg, start):
    ds = SyntheticDataset(cfg.model.vocab_size, cfg.seq_len)
    step = start
    while True:
        yield torch.from_numpy(ds.batch(cfg.seed, step, cfg.batch_size)).long()
        step += 1


@pytest.mark.parametrize("damage", ["corrupt", "truncate"])
def test_restore_falls_back_to_newest_intact_step(trained_ckpt, tmp_path, damage):
    d = str(tmp_path / "ck")
    shutil.copytree(trained_ckpt, d)
    damage_fn = inject.corrupt_step if damage == "corrupt" else inject.truncate_step
    assert damage_fn(d, 4) == [step_path(d, 4)]
    cfg = tiny_cfg(d, steps=4)
    trainer = Trainer(cfg, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        start = trainer.restore(Checkpointer(d, save_every=10_000))
    assert start == 2, "must fall back to the newest intact step"
    msgs = " | ".join(str(x.message) for x in w)
    assert "corrupt or incomplete" in msgs and "skipping corrupt step" in msgs
    last = trainer.train(_resume_batches(cfg, start))
    assert np.isfinite(last["loss"]) and trainer.step_count == 4


def test_resave_overwrites_step_that_failed_verification(trained_ckpt, tmp_path):
    """C7: after a fallback restore, reaching the corrupt step again must
    overwrite the known-bad file, not be skipped as already saved --
    otherwise an "emergency checkpoint saved" message would be false."""
    d = str(tmp_path / "ck")
    shutil.copytree(trained_ckpt, d)
    inject.corrupt_step(d, 4)
    cfg = tiny_cfg(d, steps=4)
    trainer = Trainer(cfg, device="cpu")
    ck = Checkpointer(d, save_every=10_000)
    assert _quiet(trainer.restore, ck) == 2
    trainer.train(_resume_batches(cfg, 2))  # back at step 4
    assert ck.maybe_save(4, trainer.state_dict(), force=True), (
        "the known-bad step 4 must be overwritten, not skipped")
    restored = ck.restore(step=4)  # verifies
    _equal(restored["params"], _state(trainer)[0])
    assert not ck.maybe_save(4, trainer.state_dict(), force=True)  # idempotent again


def test_explicitly_pinned_step_never_falls_back(trained_ckpt, tmp_path):
    d = str(tmp_path / "ck")
    shutil.copytree(trained_ckpt, d)
    inject.corrupt_step(d, 4)
    with pytest.raises(Exception):  # the caller pinned step 4: no fallback
        Trainer(tiny_cfg(d), device="cpu").restore(Checkpointer(d), step=4)


# ---------------------------------------------------------------------------
# end to end through train()
# ---------------------------------------------------------------------------


def _jax_train(cfg, plan=None, resume=False):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train_mod, "Trainer", SeededJaxTrainer)
        with jax_inject.inject(plan or jax_inject.FaultPlan()):
            return _quiet(jax_train_mod.train, cfg, data="synthetic", resume=resume)


def test_preemption_resume_bitwise_and_against_jax(tmp_path, monkeypatch):
    """SIGTERM at step 3 (off the save cadence) -> graceful stop, emergency
    checkpoint -> the resumed run lands bitwise on the uninterrupted one; the
    JAX package's run stops at the same boundary and ends within 1e-5."""
    monkeypatch.setattr(train_mod, "Trainer", SeededTrainer)
    a, _ = _quiet(train_mod.train, tiny_cfg(str(tmp_path / "a")), resume=False, device="cpu")
    cfg_b = tiny_cfg(str(tmp_path / "b"))
    plan = inject.FaultPlan().preempt_at(3)
    with inject.inject(plan):
        b, _ = _quiet(train_mod.train, cfg_b, resume=False, device="cpu")
    assert plan.delivered == ["train.step_boundary@3"]
    assert b.preempted_at == 3 and b.step_count == 3
    # the emergency save is off the cadence: the preemption wrote it
    assert os.path.exists(step_path(cfg_b.ckpt_dir, 3))
    flights = os.listdir(os.path.join(cfg_b.ckpt_dir, "flight"))
    assert any(f.endswith("train-preempt.json") for f in flights), flights
    b2, _ = _quiet(train_mod.train, cfg_b, resume=True, device="cpu")
    assert b2.step_count == 6 and b2.preempted_at is None
    for got, want in zip(_state(b2), _state(a)):
        if isinstance(got, dict) and got and isinstance(next(iter(got.values())), dict):
            for k in want:
                _equal(got[k], want[k])
        else:
            _equal(got, want)

    jcfg = JaxTrainConfig(model=JAX_TINY, mesh=JaxMeshConfig(dp=1), ckpt_dir=str(tmp_path / "j"),
                          **KW)
    jplan = jax_inject.FaultPlan().preempt_at(3)
    jstate, _ = _jax_train(jcfg, jplan)
    assert jplan.delivered == plan.delivered and int(jstate.step) == b.preempted_at
    jstate, _ = _jax_train(jcfg, resume=True)
    ref = params_from_jax(jax.device_get(jstate.params), TINY)
    for n, p in b2.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_nan_poison_skip_policy_continues(tmp_path):
    cfg = tiny_cfg(str(tmp_path / "ck"), steps=4, ckpt_every=100)
    plan = inject.FaultPlan().poison_nan_at(2)
    with inject.inject(plan):
        trainer, last = _quiet(train_mod.train, cfg, resume=False, device="cpu")
    assert plan.delivered == ["train.nan@2"]
    assert trainer.step_count == 4 and trainer.nonfinite == 1
    assert np.isfinite(last["loss"])
    assert all(bool(torch.isfinite(p).all()) for p in trainer.params.values()), (
        "the poisoned step must not leak NaN into the params")


def test_a_poisoned_step_leaves_the_params_of_the_step_before():
    trainer = SeededTrainer(tiny_cfg(), device="cpu")
    b = list(_resume_batches(trainer.cfg, 0).__next__() for _ in range(1))[0]
    trainer.step(b)
    before = _state(trainer)
    with inject.inject(inject.FaultPlan().poison_nan_at(2)):
        m = trainer.step(b)
    assert m["nonfinite"] == 1.0 and not np.isfinite(m["loss"])
    for got, want in zip(_state(trainer), before):
        for k in want:
            if isinstance(want[k], dict):
                _equal(got[k], want[k])
            else:
                assert torch.equal(got[k], want[k]), k


def test_nan_poison_halt_saves_emergency_checkpoint(tmp_path):
    """nan_policy='halt' saves the offending state before it raises, so the
    failure is restorable post mortem."""
    cfg = tiny_cfg(str(tmp_path / "ck"), steps=4, ckpt_every=100, nan_policy="halt")
    with inject.inject(inject.FaultPlan().poison_nan_at(2)):
        with pytest.raises(FloatingPointError, match="emergency checkpoint saved at step 2"):
            _quiet(train_mod.train, cfg, resume=False, device="cpu")
    ck = Checkpointer(cfg.ckpt_dir)
    assert ck.latest_step == 2  # ckpt_every=100: only the emergency save
    trainer = Trainer(cfg, device="cpu")
    assert trainer.restore(ck) == 2 and trainer.nonfinite == 1
    flights = os.listdir(os.path.join(cfg.ckpt_dir, "flight"))
    assert any(f.endswith("train-nan-halt.json") for f in flights), flights


def test_ckpt_io_retry_through_train(tmp_path):
    """A save that fails twice at step 2 still lands, and restores verified."""
    cfg = tiny_cfg(str(tmp_path / "ck"), steps=2)
    plan = inject.FaultPlan().fail_io("ckpt.save", step=2, times=2)
    with inject.inject(plan), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        trainer, _ = train_mod.train(cfg, resume=False, device="cpu")
    assert sum("retrying" in str(x.message) for x in w) == 2
    restored = Checkpointer(cfg.ckpt_dir).restore()
    _equal(restored["params"], _state(trainer)[0])


# ---------------------------------------------------------------------------
# the OOM fallback
# ---------------------------------------------------------------------------


def test_oom_fallback_retries_at_remat_skip_0_bitwise():
    """An out-of-memory error in the forward at remat_skip=1 is retried once
    fully rematted: the step is bitwise a remat_skip=0 trainer's."""
    model = dataclasses.replace(TINY, n_layers=2, remat=True, remat_skip=1)
    cfg = tiny_cfg(model=model)
    batch = next(_resume_batches(cfg, 0))
    ref = SeededTrainer(dataclasses.replace(cfg, model=dataclasses.replace(model, remat_skip=0)),
                        device="cpu")
    want = ref.step(batch)
    tr = SeededTrainer(cfg, device="cpu")
    calls = []
    forward = type(tr.model).forward

    def oom_once(self, *a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return forward(self, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(tr.model), "forward", oom_once)
        mp.setattr("orion_tpu_torch.training.trainer.fused_ce_ok", lambda m: False)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            got = tr.step(batch)
    assert len(calls) == 2 and tr.model.cfg.remat_skip == 0
    assert any("retrying fully rematted" in str(x.message) for x in w)
    assert got == want
    _equal(_state(tr)[0], _state(ref)[0])
    assert not any(p.grad is not None for p in tr.params.values())


def test_oom_without_remat_skip_is_raised():
    tr = SeededTrainer(tiny_cfg(), device="cpu")
    batch = next(_resume_batches(tr.cfg, 0))

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tr, "_loss_and_grads", oom)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            tr.step(batch)
    assert tr.step_count == 0
