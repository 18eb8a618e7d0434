"""The pipeline axis of the port's mesh (pp) and its GPipe schedule held
against the JAX package, on the CPU.

- Rank layout and groups: one spawn of four gloo ranks
  (``tests/torch_pp_workers.py``) builds dp 2 x pp 2, fsdp 2 x pp 2, tp 2 x pp
  2, sp 2 x pp 2 and pp 4; each rank's (d, f, t, s, p) against the JAX mesh's
  device order (``make_mesh``: ``reshape(dp, fsdp, tp, sp, pp, ep)``) and
  every group against the ranks that differ only along its axes.
- The schedule (``parallel/pipeline.py::gpipe``) in the same spawn:
  ``tests/test_pipeline.py``'s residual layers and seeds at (pp, n_micro) =
  (2, 4), (4, 4), (4, 8) and pp 1 against the JAX sequential stack (which
  the JAX package's ``pipeline_apply`` equals: ``tests/test_pipeline.py``): the
  output of its forward problem (8 layers of d 16, hidden 32; 1e-5, the JAX
  test's), the loss sum(out^2) of its gradient problem (4 layers of d 8,
  hidden 16; 1e-5) and its gradient for every layer and for the input
  (1e-4, the JAX test's).
- ``stage_group`` against the JAX package's for the configs that pipeline
  (and the aperiodic one that does not); ``stage_blocks``; the bubble.
- ``unstack_lm_params`` against ``orion_tpu.parallel.pipeline_lm``'s stack:
  bitwise for an all-linear tree, a hybrid (swa, swa, linear) x 2 by
  groups, and the older layout without ``sub_0``.
- The pp rules of the Trainer against the JAX Trainer's: the auto
  ``pp_microbatches`` at batch 12 and at accumulation 4 (pp 2), an
  ``n_micro`` that does not divide a rank's rows, pp that does not divide
  the groups; and what pp refuses: ``optimizer="adafactor"`` and
  ``param_storage="bfloat16_sr"`` (``NotImplementedError`` naming A12 step
  9, before any collective: the Mesh here has no process group), ep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pp_workers as pp_workers
import torch_sp_workers as workers
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from orion_tpu.parallel.mesh import make_mesh
from orion_tpu.parallel import pipeline_lm as jax_pipeline_lm
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel.mesh import Mesh, MeshConfig
from orion_tpu_torch.parallel.pipeline import bubble_fraction
from orion_tpu_torch.parallel.pipeline_lm import stage_blocks, stage_group, unstack_lm_params

GROUP_MESHES = (MeshConfig(dp=2, pp=2), MeshConfig(dp=1, fsdp=2, pp=2),
                MeshConfig(dp=1, tp=2, pp=2), MeshConfig(dp=1, sp=2, pp=2),
                MeshConfig(dp=1, pp=4))
SCHEDULE = ((MeshConfig(dp=2, pp=2), 4), (MeshConfig(dp=1, pp=4), 4),
            (MeshConfig(dp=1, pp=4), 8), (MeshConfig(dp=4), 2))
TINY = dict(name="pp_test", vocab_size=64, d_model=32, n_layers=4, n_heads=2, max_seq_len=64,
            dtype="float32")


def _layers(n_layers, d, hidden, seed):
    """``tests/test_pipeline.py``'s ``_make_layers``."""
    out = []
    for k in jax.random.split(jax.random.PRNGKey(seed), n_layers):
        k1, k2 = jax.random.split(k)
        out.append({"w1": jax.random.normal(k1, (d, hidden)) * 0.3, "b1": jnp.zeros((hidden,)),
                    "w2": jax.random.normal(k2, (hidden, d)) * 0.3})
    return out


def _layer_fn(params, x):
    return x + jnp.tanh(x @ params["w1"] + params["b1"]) @ params["w2"]


@jax.jit
def _sequential(layers, x):
    for lp in layers:
        x = _layer_fn(lp, x)
    return x


@jax.jit
def _sequential_grads(layers, x):
    return jax.value_and_grad(lambda ls, x: (_sequential(ls, x) ** 2).sum(),
                              argnums=(0, 1))(layers, x)


@pytest.fixture(scope="module")
def ranks():
    # the JAX tests' two problems: the forward's, the gradients'
    sets = {"forward": (_layers(8, 16, 32, 0), jax.random.normal(jax.random.PRNGKey(1), (8, 4, 16))),
            "grad": (_layers(4, 8, 16, 3), jax.random.normal(jax.random.PRNGKey(2), (8, 4, 8)))}
    payload = {"mesh": MeshConfig(dp=2, pp=2), "meshes": GROUP_MESHES,
               "cases": [{"mesh": m, "n_micro": n} for m, n in SCHEDULE],
               **{k: {"layers": [{n: np.asarray(v) for n, v in lp.items()} for lp in layers],
                      "x": np.asarray(x)} for k, (layers, x) in sets.items()}}
    return {"sets": sets, "ranks": workers.run_ranks(4, pp_workers.groups_and_schedule, payload)}


@pytest.mark.parametrize("i", range(len(GROUP_MESHES)),
                         ids=[str(m.shape[:5]) for m in GROUP_MESHES])
def test_rank_coordinates_and_groups_match_the_jax_mesh(ranks, i):
    cfg = GROUP_MESHES[i]
    jmesh = make_mesh(JaxMeshConfig(dp=cfg.dp, fsdp=cfg.fsdp, tp=cfg.tp, sp=cfg.sp, pp=cfg.pp))
    shape = (cfg.dp, cfg.fsdp, cfg.tp, cfg.sp, cfg.pp)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(shape)
    axes = {"dp_group": (0,), "fsdp_group": (1,), "tp_group": (2,), "sp_group": (3,),
            "pp_group": (4,), "data_group": (0, 1), "replica_group": (0, 1, 3),
            "trunk_group": (0, 1, 3, 4),
            "shard_group": (0, 3) if cfg.fsdp > 1 else None,
            "trunk_shard_group": (0, 3, 4) if cfg.fsdp > 1 else None}
    for rank, res in enumerate(ranks["ranks"]):
        coords, groups = res["groups"][i]
        assert ids[coords] == rank
        for name, varying in axes.items():
            if varying is None:
                assert groups[name] is None, name
                continue
            index = tuple(slice(None) if a in varying else c for a, c in enumerate(coords))
            want = sorted(int(r) for r in ids[index].reshape(-1))
            assert groups[name] == (want if len(want) > 1 else None), (name, rank)


@pytest.mark.parametrize("case", range(len(SCHEDULE)),
                         ids=[f"pp{m.pp}-n{n}" for m, n in SCHEDULE])
def test_schedule_matches_the_jax_pipeline_and_the_sequential_stack(ranks, case):
    mesh_cfg, n_micro = SCHEDULE[case]
    ref = _sequential(*ranks["sets"]["forward"])
    layers, x = ranks["sets"]["grad"]
    jloss, (glayers, gx) = _sequential_grads(layers, x)
    results = [r["schedule"][case] for r in ranks["ranks"]]
    outs = [r["out"] for r in results if r["out"] is not None]
    assert len(outs) == 4 // mesh_cfg.pp  # the last stage of each pipeline
    seen = set()
    for r in results:
        if r["out"] is not None:
            np.testing.assert_allclose(r["out"], np.asarray(ref), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(r["loss"], float(jloss), rtol=1e-5)
        for i, g in r["grads"].items():
            seen.add(i)
            for k, v in g.items():
                np.testing.assert_allclose(v, np.asarray(glayers[i][k]), atol=1e-4, rtol=1e-4,
                                           err_msg=f"layer {i} {k}")
        if r["x_grad"] is not None:
            np.testing.assert_allclose(r["x_grad"], np.asarray(gx), atol=1e-4, rtol=1e-4)
    assert seen == set(range(len(layers)))


@pytest.mark.parametrize("name,over,g", [
    ("linear", {}, 1),
    ("hybrid", {"n_layers": 6, "layer_types": ("swa", "swa", "linear") * 2, "window": 4}, 3),
    ("moe every other", {"n_experts": 4, "moe_period": 2}, 2),
    ("aperiodic", {"n_layers": 3, "layer_types": ("swa", "linear", "linear")}, 3),
])
def test_stage_group_matches_the_jax_package(name, over, g):
    cfg = dict(TINY, **over)
    assert stage_group(ModelConfig(**cfg)) == g
    assert jax_pipeline_lm.stage_group(JaxModelConfig(**cfg)) == g


def test_stage_blocks_are_whole_groups_and_pp_must_divide_them():
    hybrid = ModelConfig(**dict(TINY, n_layers=8, layer_types=("swa", "swa", "swa", "linear") * 2))
    assert [list(stage_blocks(hybrid, 2, p)) for p in range(2)] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert list(stage_blocks(ModelConfig(**TINY), 4, 3)) == [3]
    with pytest.raises(ValueError, match="stage groups"):
        stage_blocks(hybrid, 4, 0)
    assert bubble_fraction(2, 8) == pytest.approx(1 / 9)
    assert bubble_fraction(1, 4) == 0.0


@pytest.mark.parametrize("name,over", [
    ("linear", {}),
    ("hybrid", {"n_layers": 6, "layer_types": ("swa", "swa", "linear") * 2, "window": 4}),
    ("legacy", {}),
])
def test_unstack_lm_params_inverts_the_jax_stack(name, over):
    jcfg = JaxModelConfig(**dict(TINY, **over))
    model = JaxLM(jcfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32)))
    stacked = jax.device_get(jax_pipeline_lm.stack_lm_params(model, params))
    if name == "legacy":  # one block an element, no "sub_0"
        stacked["params"]["blocks_stacked"] = stacked["params"]["blocks_stacked"]["sub_0"]
    back = unstack_lm_params(stacked, ModelConfig(**dict(TINY, **over)))
    assert "blocks_stacked" not in back["params"]
    flat_b, flat_p = jax.tree_util.tree_flatten_with_path(back)[0], \
        jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_p]
    for (path, a), (_, b) in zip(flat_b, flat_p):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def _fake_mesh(cfg, rank=0):
    """This rank's ``Mesh`` of ``cfg`` without a process group (the Trainer
    refuses or plans before any collective)."""
    world = cfg.dp * cfg.fsdp * cfg.tp * cfg.sp * cfg.pp
    return Mesh(cfg, rank, world, torch.device("cpu"), "gloo", None)


@pytest.mark.parametrize("batch,accum,dp", [(12, 1, 1), (16, 4, 1), (8, 1, 1), (16, 1, 2)])
def test_auto_microbatches_match_the_jax_trainer(batch, accum, dp):
    from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
    from orion_tpu.training.trainer import Trainer as JaxTrainer
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    kw = dict(steps=1, batch_size=batch, seq_len=32, accum_steps=accum, warmup_steps=1)
    jt = JaxTrainer(JaxTrainConfig(model=JaxModelConfig(backend="xla", **TINY),
                                   mesh=JaxMeshConfig(dp=dp, pp=2), **kw), materialize=False)
    cfg = TrainConfig(model=ModelConfig(**TINY), mesh=MeshConfig(dp=dp, pp=2), **kw)
    tr = Trainer(cfg, mesh=_fake_mesh(cfg.mesh))
    assert tr.pp_n_micro == jt.pp_n_micro and not tr.pp_full_manual
    assert (batch // accum) % tr.pp_n_micro == 0
    assert tr.model.cfg.remat_skip == 0


def test_the_trainers_pp_rules_refuse_what_does_not_divide():
    from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
    from orion_tpu.training.trainer import Trainer as JaxTrainer
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=ModelConfig(**TINY), mesh=MeshConfig(dp=2, pp=2), batch_size=8,
                      seq_len=32, pp_microbatches=8)
    with pytest.raises(ValueError, match="pp_microbatches=8 must divide this rank's 4 rows"):
        Trainer(cfg, mesh=_fake_mesh(cfg.mesh))
    # the auto rule is the JAX Trainer's: at batch 8 it picks 8 (4 at
    # accumulation 2), which would leave a dp or fsdp rank half a row
    for mesh, accum, n, rows in ((MeshConfig(dp=2, pp=2), 1, 8, 4),
                                 (MeshConfig(dp=1, fsdp=2, pp=2), 2, 4, 2)):
        kw = dict(batch_size=8, seq_len=32, accum_steps=accum, warmup_steps=1)
        jt = JaxTrainer(JaxTrainConfig(model=JaxModelConfig(backend="xla", **TINY),
                                       mesh=JaxMeshConfig(dp=mesh.dp, fsdp=mesh.fsdp, pp=2), **kw),
                        materialize=False)
        assert jt.pp_n_micro == n
        cfg = TrainConfig(model=ModelConfig(**TINY), mesh=mesh, **kw)
        with pytest.raises(ValueError, match=f"pp_microbatches={n} must divide this rank's "
                                             f"{rows} rows.*whole rows"):
            Trainer(cfg, mesh=_fake_mesh(cfg.mesh))
    hybrid = ModelConfig(**dict(TINY, n_layers=8, layer_types=("swa", "swa", "swa", "linear") * 2))
    cfg = TrainConfig(model=hybrid, mesh=MeshConfig(dp=1, pp=4), batch_size=8, seq_len=32)
    with pytest.raises(ValueError, match="stage groups"):
        Trainer(cfg, mesh=_fake_mesh(cfg.mesh))
    cfg = TrainConfig(model=ModelConfig(**TINY), mesh=MeshConfig(dp=1, pp=2), batch_size=8,
                      seq_len=32)
    with pytest.raises(ValueError, match="init_distributed"):
        Trainer(cfg, device="cpu")
    # full-manual: the base is a rank's rows, and the MoE statistics stay local
    cfg = TrainConfig(model=ModelConfig(**dict(TINY, n_experts=4, moe_period=2)),
                      mesh=MeshConfig(dp=2, pp=2), batch_size=8, seq_len=32, pp_full_manual=True)
    tr = Trainer(cfg, mesh=_fake_mesh(cfg.mesh))
    assert tr.pp_full_manual and tr.pp_n_micro == 4
    assert all(m.stats_group is None for m in tr.model.modules() if hasattr(m, "router"))


@pytest.mark.parametrize("kw", [dict(optimizer="adafactor"), dict(param_storage="bfloat16_sr")])
def test_adafactor_and_bf16_sr_under_pp_raise_naming_step_9(kw):
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    for mesh in (MeshConfig(dp=1, pp=2), MeshConfig(dp=2, pp=2)):
        cfg = TrainConfig(model=ModelConfig(**TINY), mesh=mesh, batch_size=8, seq_len=16, **kw)
        with pytest.raises(NotImplementedError, match="item 12.*A12 step 9"):
            Trainer(cfg, mesh=_fake_mesh(cfg.mesh))


def test_ep_still_raises_and_pp_is_accepted():
    with pytest.raises(NotImplementedError, match="A12 step 8"):
        MeshConfig(dp=1, ep=2).check()
    for cfg in (MeshConfig(dp=1, pp=2), MeshConfig(dp=2, fsdp=2, tp=2, sp=2, pp=2)):
        cfg.check()


def test_a_stage_model_holds_its_blocks_only_and_refuses_whole_depth_calls():
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = ModelConfig(**TINY)
    whole = TransformerLM(cfg, device="cpu").state_dict()
    for p in range(2):
        model = TransformerLM(cfg, device="cpu", mesh=_fake_mesh(MeshConfig(dp=1, pp=2), p))
        mine = model.state_dict()
        blocks = sorted({int(k.split(".")[1]) for k in mine if k.startswith("blocks.")})
        assert blocks == [2 * p, 2 * p + 1]
        assert "embed.weight" in mine and "final_norm.weight" in mine
        for n, t in mine.items():  # drawn whole in the pp=1 order, then cut
            torch.testing.assert_close(t, whole[n], rtol=0, atol=0)
        assert model.shard_state(whole).keys() == mine.keys()
        with pytest.raises(ValueError, match="pipeline stage"):
            model(torch.zeros((1, 4), dtype=torch.long))
        with pytest.raises(ValueError, match="pipeline stage"):
            model.prefill(torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="A12 step 8"):
        TransformerLM(cfg, device="cpu", mesh=_fake_mesh(MeshConfig(dp=1, pp=2)), quant="int8")
