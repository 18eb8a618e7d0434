"""The port's Trainer on four gloo CPU ranks with pp -- pp 4, and pp 2
composed with each of dp, fsdp, tp and sp -- held against the JAX package's
Trainer, on the CPU.

One spawn (``tests/torch_pp_workers.py``'s ``trainer_runs``, over
``torch_sp_workers.mesh_runs``) runs every case, each on its own mesh of the
one process group, two steps from the JAX Trainer's params on the same
synthetic batches, the whole params gathered over every stage after:

- ``tests/test_pipeline.py::test_trainer_pipeline_parallel_parity``'
  all-linear LM (4 blocks, d 32, fp32) at pp 4, one block a stage;
- ``tests/test_sharding.py``'s linear + softmax pattern, twice (4 blocks in
  2 groups), at pp 2 x dp 2, pp 2 x fsdp 2, pp 2 x tp 2 and pp 2 x sp 2 (the
  softmax layers through the ring);
- ``test_trainer_pp_accum_and_odd_batch``' cases at pp 2 (x dp 2, for the
  four ranks): accumulation 4 over a batch of 16 (n_micro pinned to 2: the
  auto rule's 4 would leave a dp rank half a row, which the Trainer
  refuses), and a batch of 12.

The dp 2 and fsdp 2 runs take a batch of 16, so that the auto n_micro, the
JAX rule's 8, leaves every rank whole rows.

Each against the JAX Trainer at ``MeshConfig(dp=1)`` from the same params:
the loss and the grad norm of both steps and every param after them within
3e-5 (the JAX pp tests' tolerance), on every rank; the ranks' params bitwise
one another's. The pp 2 x dp 2 run also against the JAX Trainer at the same
mesh (its stacked state unstacked with ``unstack_lm_params``), and the
Trainer's eval there against the JAX one's (2e-5).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_pp_workers as pp_workers
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from orion_tpu.training.data import SyntheticDataset
from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
from orion_tpu.training.trainer import Trainer as JaxTrainer
from orion_tpu_torch.convert import params_from_jax
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel.mesh import MeshConfig
from orion_tpu_torch.parallel.pipeline_lm import unstack_lm_params

import torch_sp_workers as workers

_TOL = dict(rtol=3e-5, atol=3e-5)
LINEAR = dict(name="pp_trainer_test", vocab_size=64, d_model=32, n_layers=4, n_heads=2,
              max_seq_len=64, dtype="float32")
MIXED = dict(LINEAR, name="pp_mixed", layer_types=("linear", "softmax") * 2)
KW = dict(steps=2, batch_size=8, seq_len=16, lr=1e-3, warmup_steps=1, log_every=100)
# at dp x fsdp = 2 the auto n_micro (8, the JAX rule's) needs 8 rows a rank
KW16 = dict(KW, batch_size=16)
# the JAX rule's 4 would leave a dp rank half a row: pinned to 2
ACCUM = dict(KW, batch_size=16, accum_steps=4, pp_microbatches=2)
ODD = dict(KW, batch_size=12)
RUNS = {  # name: (model, mesh, kw)
    "pp4": (LINEAR, MeshConfig(dp=1, pp=4), KW),
    "pp2 dp2": (MIXED, MeshConfig(dp=2, pp=2), KW16),
    "pp2 fsdp2": (MIXED, MeshConfig(dp=1, fsdp=2, pp=2), KW16),
    "pp2 tp2": (MIXED, MeshConfig(dp=1, tp=2, pp=2), KW),
    "pp2 sp2": (dict(MIXED, sequence_parallel=True), MeshConfig(dp=1, sp=2, pp=2), KW),
    "accum 4": (LINEAR, MeshConfig(dp=2, pp=2), ACCUM),
    "batch 12": (LINEAR, MeshConfig(dp=2, pp=2), ODD),
}


def _batches(kw, n=2):
    ds = SyntheticDataset(64, kw["seq_len"])
    return [np.asarray(ds.batch(0, i, kw["batch_size"])) for i in range(n)]


def _jax_trainer(model, kw, mesh):
    over = {k: v for k, v in model.items() if k != "sequence_parallel"}
    return JaxTrainer(JaxTrainConfig(model=JaxModelConfig(backend="xla", **over), mesh=mesh,
                                     **kw))


def _steps(tr, batches):
    """The JAX Trainer's losses and grad norms over ``batches``, its final
    params tree."""
    ms = [tr.step(jnp.asarray(b)) for b in batches]
    return ([float(m["loss"]) for m in ms], [float(m["grad_norm"]) for m in ms],
            jax.device_get(tr.state.params))


@pytest.fixture(scope="module")
def runs():
    refs, port = {}, {}
    for name, (model, mesh, kw) in RUNS.items():
        key = (model["name"], tuple(sorted(kw.items())))
        if key not in refs:
            tr = _jax_trainer(model, kw, JaxMeshConfig(dp=1))
            refs[key] = (tr, jax.device_get(tr.state.params))
        batches = _batches(kw)
        port[name] = dict(mesh=mesh, model=ModelConfig(**model), tree=refs[key][1],
                          batches=batches, kw=kw,
                          eval=batches if name == "pp2 dp2" else None)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(workers.run_ranks, 4, pp_workers.trainer_runs,
                            {"mesh": MeshConfig(dp=2, pp=2), "kw": KW,
                             "runs": list(port.values())}, 240)
        jax_runs = {}
        for key, (tr, _) in refs.items():
            kw = dict(key[1])
            jax_runs[key] = _steps(tr, _batches(kw))
        # its init is the dp=1 one's, stacked (the same draws)
        same = _jax_trainer(MIXED, KW16, JaxMeshConfig(dp=2, pp=2))
        ev = _eval(same, _batches(KW16))
        mesh_run = _steps(same, _batches(KW16))
        same_n_micro = same.pp_n_micro
        ranks = spawn.result()
    return {"jax": jax_runs, "same mesh": (mesh_run, ev), "same n_micro": same_n_micro,
            "port": {name: [r[i] for r in ranks] for i, name in enumerate(port)}}


def _eval(trainer, batches):
    s = c = 0.0
    for b in batches:
        si, ci = trainer._eval_fn(trainer.state.params, jnp.asarray(b))
        s, c = s + float(si), c + float(ci)
    return s / c


def _check(ranks, losses, norms, tree, cfg):
    ref = params_from_jax(tree, cfg)
    for r_losses, r_norms, params, _, _ in ranks:
        np.testing.assert_allclose(r_losses, losses, **_TOL)
        np.testing.assert_allclose(r_norms, norms, **_TOL)
        assert params.keys() == ref.keys()
        for n, p in params.items():
            np.testing.assert_allclose(p, ref[n].numpy(), **_TOL, err_msg=n)
    for _, _, params, _, _ in ranks[1:]:
        for n, p in params.items():
            np.testing.assert_array_equal(p, ranks[0][2][n], err_msg=n)


@pytest.mark.parametrize("name", list(RUNS))
def test_two_steps_on_a_pp_mesh_equal_the_jax_trainer(runs, name):
    model, mesh, kw = RUNS[name]
    key = (model["name"], tuple(sorted(kw.items())))
    _check(runs["port"][name], *runs["jax"][key], ModelConfig(**model))
    extra = [r[4] for r in runs["port"][name]]
    cfg = ModelConfig(**model)
    per = cfg.n_layers // mesh.pp
    assert {tuple(e["blocks"]) for e in extra} == {tuple(range(p * per, (p + 1) * per))
                                                   for p in range(mesh.pp)}
    rows = kw["batch_size"] // kw.get("accum_steps", 1) // (mesh.dp * mesh.fsdp)
    assert all(rows % e["n_micro"] == 0 for e in extra)


def test_pp2_dp2_equals_the_jax_trainer_at_the_same_mesh(runs):
    """The JAX pp 2 x dp 2 Trainer's stacked state, unstacked, against the
    port's pp 2 x dp 2 run, and the two Trainers' eval of the same params."""
    (losses, norms, tree), ev = runs["same mesh"]
    cfg = ModelConfig(**MIXED)
    _check(runs["port"]["pp2 dp2"], losses, norms, unstack_lm_params(tree, cfg), cfg)
    for r in runs["port"]["pp2 dp2"]:
        np.testing.assert_allclose(r[4]["eval"]["eval_loss"], ev, rtol=2e-5)


def test_the_microbatch_counts(runs):
    """The JAX auto rule's n_micro, the largest divisor of the micro-batch up
    to 4 pp: 8 at pp 4 over 8 rows, 8 at pp 2 x dp 2 and x fsdp 2 over 16
    rows (the JAX pp 2 x dp 2 Trainer's own), 6 over 12 rows; 2 where it is
    pinned (accumulation 4 over 16)."""
    assert runs["same n_micro"] == 8
    want = {"pp4": 8, "pp2 dp2": 8, "pp2 fsdp2": 8, "accum 4": 2, "batch 12": 6}
    for name, n in want.items():
        assert {r[4]["n_micro"] for r in runs["port"][name]} == {n}, name
        assert not any(r[4]["full_manual"] for r in runs["port"][name])
