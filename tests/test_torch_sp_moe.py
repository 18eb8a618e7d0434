"""MoE layers on a sequence-parallel mesh held against the JAX package, on
gloo CPU ranks (``tests/torch_combo_workers.py``; one 2-rank and one 4-rank
spawn, the JAX references computed meanwhile).

- Training: ``tests/test_moe.py::test_moe_composes_with_sequence_parallel``'s
  model (linear, softmax, linear, swa; window 8; ``moe_group_size`` 8; fp32;
  its ep axis left out, A12 step 8), in the capacity form (capacity factor
  1, so groups drop tokens) and the dropless form, at top-1 and top-2. The
  port's Trainer at sp 2, dp 2 x sp 2 and sp 2 x tp 2 from the JAX params
  against the JAX Trainer at dp 2 x sp 2 (GSPMD computes the one-device
  function on any mesh; one JAX Trainer a form is shared by the three
  meshes): each step's loss within 2e-5 and the params after two steps
  within 3e-5, the sp trainer tests' tolerances. The load-balance
  statistics are the global batch's, over the data x sp ranks.
- A capacity group that would straddle two sp shards (T 24 at sp 2, group
  8) raises ``ValueError`` naming the rule (``models/moe.py``).
- pp 2 x sp 2: ``tests/test_moe.py::test_moe_composes_with_pp_and_sp``'s
  model at ``moe_aux_weight`` 0 and 1e-2 against the JAX Trainer at pp 2 x
  sp 2: the port follows the JAX pipeline body's per-shard load-balance
  term, so the loss is held at JAX's own 1e-5 without the term and at the
  sp Trainer's 2e-5 with it (a global term is off by far more), and the
  params at 3e-5.
- ``generate`` at sp 2 on a dropless and a capacity MoE: every rank's
  greedy tokens equal JAX ``generate(..., mesh=...)``'s at sp 2.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_combo_workers as combo
import torch_sp_workers as workers
from orion_tpu.generate import SampleConfig as JaxSampleConfig
from orion_tpu.generate import generate as jax_generate
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig, make_mesh
from orion_tpu.training.data import SyntheticDataset
from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
from orion_tpu.training.trainer import Trainer as JaxTrainer
from orion_tpu_torch.convert import params_from_jax
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel.mesh import MeshConfig

KW = dict(steps=2, batch_size=8, seq_len=32, lr=1e-3, warmup_steps=1, log_every=100)
BASE = dict(name="moe_test", vocab_size=64, d_model=32, n_layers=4, n_heads=2, max_seq_len=64,
            dtype="float32", n_experts=4, moe_period=2, moe_top_k=1, moe_capacity_factor=4.0)
SP_MODEL = dict(BASE, layer_types=("linear", "softmax", "linear", "swa"), window=8,
                sequence_parallel=True, moe_group_size=8)
# (label, the form's fields)
FORMS = (("capacity top-1", dict(moe_capacity_factor=1.0)),
         ("capacity top-2", dict(moe_capacity_factor=1.0, moe_top_k=2)),
         ("dropless top-1", dict(moe_dropless=True)),
         ("dropless top-2", dict(moe_dropless=True, moe_top_k=2)))
MESHES = {2: (dict(sp=2),), 4: (dict(dp=2, sp=2), dict(sp=2, tp=2))}
PP_AUX = (0.0, 1e-2)
# the loss at JAX's own 1e-5 without the term; with it, where the JAX test
# allows 5e-3 for the gap between the per-shard and the global term, at the
# sp Trainer's 2e-5: both runs take the per-shard term on the same mesh
PP_TOL = {0.0: 1e-5, 1e-2: 2e-5}
GEN = dict(name="genmesh_moe", vocab_size=64, d_model=32, n_layers=2, n_heads=2,
           layer_types=("linear", "swa"), window=4, max_seq_len=64, dtype="float32",
           n_experts=4, moe_period=2)
GEN_FORMS = (("dropless", dict(moe_dropless=True)), ("capacity", {}))
NEW = 9


def _batches(seq_len=32):
    ds = SyntheticDataset(64, seq_len)
    return [np.asarray(ds.batch(0, i, 8)) for i in range(2)]


class _JaxRun:
    """The JAX Trainer of the model ``fields`` on ``mesh``: ``tree``, its
    initial params, at once; ``result()``, (its step losses, its params after
    the steps), on first call."""

    def __init__(self, fields, mesh, **kw):
        self.tr = JaxTrainer(JaxTrainConfig(model=JaxModelConfig(backend="xla", **fields),
                                            mesh=JaxMeshConfig(**mesh), **{**KW, **kw}))
        self.tree = jax.device_get(self.tr.state.params)
        self._out = None

    def result(self):
        if self._out is None:
            losses = [float(self.tr.step(jnp.asarray(b))["loss"]) for b in _batches()]
            self._out = (losses, jax.device_get(self.tr.state.params))
        return self._out


def _sp_fields(form):
    return dict(SP_MODEL, **form)


def _pp_fields(aux):
    return dict(BASE, sequence_parallel=True, moe_group_size=8, moe_aux_weight=aux)


@functools.lru_cache(maxsize=None)
def _jax_sp(i):
    return _JaxRun(_sp_fields(FORMS[i][1]), dict(dp=2, sp=2))


@functools.lru_cache(maxsize=None)
def _jax_pp(aux):
    return _JaxRun(_pp_fields(aux), dict(dp=1, sp=2, pp=2), pp_microbatches=1)


@functools.lru_cache(maxsize=None)
def _jax_gen_model(i):
    """(the JAX MoE model of ``GEN_FORMS[i]``, its params from seed 0)."""
    jm = JaxLM(JaxModelConfig(backend="xla", **dict(GEN, **GEN_FORMS[i][1])))
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))


@functools.lru_cache(maxsize=None)
def _jax_gen(i):
    """The JAX MoE model's greedy tokens at sp 2."""
    jm, params = _jax_gen_model(i)
    return np.asarray(jax_generate(jm, params, jnp.asarray(_prompt()), NEW,
                                   JaxSampleConfig(temperature=0.0),
                                   mesh=make_mesh(JaxMeshConfig(dp=1, sp=2))))


def _prompt():
    return np.array(jax.random.randint(jax.random.PRNGKey(3), (4, 8), 0, GEN["vocab_size"]))


def _run(fields, tree, mesh, **kw):
    return {"model": ModelConfig(**fields), "tree": tree, "batches": _batches(),
            "mesh": MeshConfig(**{"dp": 1, **mesh}), "kw": kw}


@pytest.fixture(scope="module")
def runs():
    """{world: each rank's ``combo.sp_moe`` result}: the JAX trees first,
    then the ranks while the JAX Trainers take their steps."""
    trees = [_jax_sp(i).tree for i in range(len(FORMS))]
    pp_trees = [_jax_pp(aux).tree for aux in PP_AUX]
    gen_trees = [_jax_gen_model(i)[1] for i in range(len(GEN_FORMS))]
    straddle = dict(model=ModelConfig(**_sp_fields(FORMS[0][1])), mesh=MeshConfig(dp=1, sp=2),
                    kw=dict(KW, seq_len=24), batch=_batches(24)[0])
    generate = [dict(model=ModelConfig(**dict(GEN, **form)), tree=gen_trees[i], prompt=_prompt(),
                     new=NEW, mesh=MeshConfig(dp=1, sp=2))
                for i, (_, form) in enumerate(GEN_FORMS)]
    payloads = {
        2: {"kw": KW, "mesh": MeshConfig(dp=1, sp=2), "straddle": straddle,
            "generate": generate,
            "runs": [_run(_sp_fields(form), trees[i], mesh)
                     for i, (_, form) in enumerate(FORMS) for mesh in MESHES[2]]},
        4: {"kw": KW, "mesh": MeshConfig(dp=4),
            "runs": [_run(_sp_fields(form), trees[i], mesh)
                     for i, (_, form) in enumerate(FORMS) for mesh in MESHES[4]]
            + [_run(_pp_fields(aux), pp_trees[j], dict(sp=2, pp=2), pp_microbatches=1)
               for j, aux in enumerate(PP_AUX)]},
    }
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        got = {w: pool.submit(workers.run_ranks, w, combo.sp_moe, payloads[w], 240)
               for w in payloads}
        for i in range(len(FORMS)):
            _jax_sp(i).result()
        for aux in PP_AUX:
            _jax_pp(aux).result()
        for i in range(len(GEN_FORMS)):
            _jax_gen(i)
        return {w: f.result() for w, f in got.items()}


def _cases():
    out = []
    for world, meshes in MESHES.items():
        for i, (label, _) in enumerate(FORMS):
            for j, mesh in enumerate(meshes):
                out.append((label, mesh, world, i * len(meshes) + j, i))
    return out


def _check(ranks, k, fields, want_losses, want_params, loss_tol, param_tol):
    ref = params_from_jax(want_params, ModelConfig(**fields))
    for r, res in enumerate(ranks):
        losses, _, params, _ = res["runs"][k]
        np.testing.assert_allclose(losses, want_losses, rtol=loss_tol, atol=loss_tol,
                                   err_msg=f"rank {r}")
        for n, p in params.items():
            np.testing.assert_allclose(p, ref[n].numpy(), rtol=param_tol, atol=param_tol,
                                       err_msg=f"rank {r} {n}")
    for res in ranks[1:]:  # the ranks agree bitwise
        for n, p in res["runs"][k][2].items():
            np.testing.assert_array_equal(p, ranks[0]["runs"][k][2][n], err_msg=n)


@pytest.mark.parametrize("label,mesh,world,k,i", _cases(),
                         ids=[f"{c[0]}-{'x'.join(f'{a}{n}' for a, n in c[1].items())}"
                              for c in _cases()])
def test_sp_moe_trainer_matches_the_jax_trainer(runs, label, mesh, world, k, i):
    want_losses, want_params = _jax_sp(i).result()
    _check(runs[world], k, _sp_fields(FORMS[i][1]), want_losses, want_params, 2e-5, 3e-5)


@pytest.mark.parametrize("j,aux", list(enumerate(PP_AUX)))
def test_pp_sp_moe_matches_the_jax_pp_sp_trainer(runs, j, aux):
    want_losses, want_params = _jax_pp(aux).result()
    k = sum(len(MESHES[4]) for _ in FORMS) + j
    _check(runs[4], k, _pp_fields(aux), want_losses, want_params, PP_TOL[aux], 3e-5)


def test_a_capacity_group_straddling_the_sp_shards_raises(runs):
    for res in runs[2]:
        kind, msg = res["straddle"]
        assert kind == "ValueError"
        assert "straddle the sp shards of 12 tokens" in msg and "moe_group_size" in msg


@pytest.mark.parametrize("i,form", [(i, f[0]) for i, f in enumerate(GEN_FORMS)])
def test_generate_sp2_moe_gives_the_jax_greedy_tokens(runs, i, form):
    want = _jax_gen(i)
    for r, res in enumerate(runs[2]):
        np.testing.assert_array_equal(res["generate"][i], want, err_msg=f"{form} rank {r}")


def test_moe_statistics_group_is_the_token_group():
    """The layer's statistics group: data x sp for a sequence-parallel
    model, the data group under pp (the per-shard term) and without sp."""
    import torch

    from orion_tpu_torch.models.moe import MoEMLP
    from orion_tpu_torch.parallel.mesh import Mesh

    cfg = ModelConfig(**_sp_fields({}))
    groups = dict(data_group="data", replica_group="token")
    for mesh_cfg, sp, want in ((MeshConfig(dp=2, sp=2), True, "token"),
                               (MeshConfig(dp=2, sp=2), False, "data"),
                               (MeshConfig(dp=2, sp=2, pp=2), True, "data")):
        world = 4 * mesh_cfg.pp
        mesh = Mesh(mesh_cfg, 0, world, torch.device("cpu"), "gloo", None, **groups)
        layer = MoEMLP(cfg, torch.float32, "cpu", mesh=mesh, sp=mesh if sp else None)
        assert layer.stats_group == want
    with pytest.raises(NotImplementedError, match="A12 step 8"):
        MoEMLP(cfg, torch.float32, "cpu", mesh=Mesh(MeshConfig(dp=1, ep=2), 0, 2,
                                                   torch.device("cpu"), "gloo", None))
