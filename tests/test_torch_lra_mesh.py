"""``train_lra`` on a mesh held against the JAX package's ``train_lra`` on
the same ``MeshConfig``, on gloo CPU ranks (``tests/torch_combo_workers.py``:
one 2-rank and one 4-rank spawn while the JAX runs go on here).

The JAX ``train_lra`` builds its classifier without a mesh and places the
state with ``param_shardings`` and the rows with ``batch_sharding``, so on
any mesh it computes the one-device function; the port's ranks take their
rows, fsdp and tp cut the classifier's leaves, and the step sums over the
data ranks. Both start from the JAX run's own initial params (its "init"
stream; the port's ranks load them through a classifier that stands in for
``LRAClassifier`` in ``train_lra``, ``torch_combo_workers._from_tree``) and
train ``lra_listops_linear`` and ``lra_listops_softmax`` at small widths
(d 32, 2 heads, 2 layers; fp32) on the synthetic ListOps, 3 steps of B 8 x
32 with an eval of 2 batches.

- dp 2, fsdp 2, tp 2 and dp 2 x tp 2: each step's loss and accuracy within
  1e-4 and the final params within 1e-5 relative plus 1e-5 of their
  largest magnitude (``tests/test_torch_lra.py``'s three-step tolerances),
  and the eval accuracy equal.
- dp 2 x sp 2 and fsdp 2 x pp 2: the sp and pp axes replicate (JAX's
  classifier takes no mesh), so these equal the JAX run at dp 2 and at
  fsdp 2 at the same tolerances.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_combo_workers as combo
import torch_sp_workers as workers
from orion_tpu import train_lra as jax_lra
from orion_tpu.models import configs as jax_configs
from orion_tpu.models.classifier import LRAClassifier as JaxClassifier
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from orion_tpu.utils import rng as jax_rngs
from orion_tpu_torch import train_lra as lra
from orion_tpu_torch.convert import params_from_jax
from orion_tpu_torch.models.configs import get_config
from orion_tpu_torch.parallel.mesh import MeshConfig

SMALL = dict(d_model=32, n_heads=2, n_layers=2, max_seq_len=40)
CONFIGS = ("lra_listops_linear", "lra_listops_softmax")
TRAIN = dict(task="listops", steps=3, batch_size=8, seq_len=32, warmup_steps=1, log_every=1,
             eval_every=3, eval_batches=2)
# (label, the port's mesh, world, the JAX mesh it is held against)
MESHES = (("dp2", dict(dp=2), 2, dict(dp=2)), ("fsdp2", dict(fsdp=2), 2, dict(fsdp=2)),
          ("tp2", dict(tp=2), 2, dict(tp=2)), ("dp2 x tp2", dict(dp=2, tp=2), 4, dict(dp=2, tp=2)),
          ("dp2 x sp2", dict(dp=2, sp=2), 4, dict(dp=2)),
          ("fsdp2 x pp2", dict(fsdp=2, pp=2), 4, dict(fsdp=2)))
JAX_MESHES = (dict(dp=2), dict(fsdp=2), dict(tp=2), dict(dp=2, tp=2))


def _cfgs(name):
    over = dict(SMALL, layer_types=(get_config(name).layer_types[0],) * 2)
    return (dataclasses.replace(jax_configs.get_config(name), **over),
            dataclasses.replace(get_config(name), **over))


class _Steps:
    def __init__(self):
        self.steps = {}

    def log(self, step, metrics, tokens_per_step=0):
        self.steps.setdefault(int(step), {}).update({k: float(v) for k, v in metrics.items()})


def _jax_tree(name):
    """The JAX ``train_lra``'s initial params (its "init" stream)."""
    jcfg, _ = _cfgs(name)
    root = jax_rngs.root_key(0)
    return jax.device_get(JaxClassifier(jcfg).init(
        jax_rngs.stream(root, "init"), jnp.zeros((1, TRAIN["seq_len"]), jnp.int32),
        jnp.ones((1, TRAIN["seq_len"]), bool)))


@functools.lru_cache(maxsize=None)
def _jax_run(name, mesh):
    """(the logged metrics by step, the last metrics, the final params) of
    the JAX ``train_lra`` at ``mesh`` (a tuple of items)."""
    jcfg, _ = _cfgs(name)
    steps = _Steps()
    params, last = jax_lra.train_lra(
        jax_lra.LRATrainConfig(model=jcfg, mesh=JaxMeshConfig(**{"dp": 1, **dict(mesh)}),
                               **TRAIN), steps)
    return steps.steps, last, jax.device_get(params)


@pytest.fixture(scope="module")
def runs():
    """{(config, label): each rank's (steps, last, whole params)}."""
    payloads = {}
    for w in (2, 4):
        payloads[w] = [{"cfg": lra.LRATrainConfig(model=_cfgs(name)[1], **TRAIN),
                        "tree": _jax_tree(name),
                        "runs": [{"mesh": MeshConfig(**{"dp": 1, **mesh})}
                                 for _, mesh, world, _ in MESHES if world == w]}
                       for name in CONFIGS]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        got = {(w, i): pool.submit(workers.run_ranks, w, combo.lra_runs, payloads[w][i], 240)
               for w in payloads for i in range(len(CONFIGS))}
        for name in CONFIGS:
            for mesh in JAX_MESHES:
                _jax_run(name, tuple(mesh.items()))
        got = {k: f.result() for k, f in got.items()}
    out = {}
    for i, name in enumerate(CONFIGS):
        seen = {2: 0, 4: 0}
        for label, _, world, _ in MESHES:
            out[(name, label)] = [ranks[seen[world]] for ranks in got[(world, i)]]
            seen[world] += 1
    return out


def _close(got, want, err_msg):
    tol = 1e-5 * max(float(np.abs(want).max()), 1e-30) + 1e-5 * np.abs(want)
    assert np.all(np.abs(got - want) <= tol), (err_msg, float(np.abs(got - want).max()))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("label,jax_mesh", [(m[0], m[3]) for m in MESHES])
def test_train_lra_on_a_mesh_matches_jax(runs, name, label, jax_mesh):
    want_steps, want_last, want_params = _jax_run(name, tuple(jax_mesh.items()))
    ref = params_from_jax(want_params, _cfgs(name)[1], classifier=True)
    ranks = runs[(name, label)]
    steps = ranks[0][0]
    assert sorted(steps) == sorted(want_steps)
    for s, want in want_steps.items():
        for key in ("loss", "acc", "grad_norm"):
            if key in want:
                np.testing.assert_allclose(steps[s][key], want[key], rtol=1e-4, atol=1e-4,
                                           err_msg=f"step {s} {key}")
    for r, (_, last, params) in enumerate(ranks):
        assert last["eval_acc"] == pytest.approx(want_last["eval_acc"], abs=1e-6), r
        np.testing.assert_allclose(last["loss"], want_last["loss"], rtol=1e-4, atol=1e-4)
        for n, p in params.items():
            _close(p, ref[n].numpy(), f"rank {r} {n}")
    for _, _, params in ranks[1:]:  # every rank ends with the same whole params
        for n, p in params.items():
            np.testing.assert_array_equal(p, ranks[0][2][n], err_msg=n)
