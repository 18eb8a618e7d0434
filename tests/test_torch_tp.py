"""The tp axis of the port's mesh held against the JAX package, on the CPU:
the sharding table, the rank layout and groups, Megatron's two collectives,
the cut and gather of a model's params, and what a tp mesh refuses.

- The table: ``parallel.sharding.tp_dims`` at tp 2 against
  ``orion_tpu.parallel.sharding.param_shardings`` on a ``MeshConfig(dp=1,
  tp=2)`` mesh of the conftest's virtual CPU devices, leaf by leaf, for
  ``tiny``, a hybrid, a MoE, the learnable / untied options and an MLP whose
  hidden width tp does not divide (the JAX spec is clipped there; the port
  runs that MLP whole). ``phi_proj`` and the untied ``lm_head_kernel`` are
  held whole on every tp rank (``TP_WHOLE``).
- One spawn of four gloo ranks (``tests/torch_tp_workers.py``): the rank
  coordinates and the members of every group against the JAX mesh's device
  order at (dp, fsdp, tp, sp) = (1, 2, 2, 1), (2, 1, 2, 1) and (1, 1, 2, 2);
  ``copy_to_tp`` / ``reduce_from_tp`` forward and backward against numpy
  sums (fp32 exact to 1e-6; bf16 summed in fp32 and rounded once); a
  model's params cut at fsdp 2 x tp 2 and tp 2 x sp 2, gathered back
  bitwise the one-rank model's, and ``shard_state`` bitwise each rank's
  params.
- The rows and the token shard a rank reads: the same on every tp rank of
  one (d, f, s).
- The refusals, each naming its A12 step: tp not dividing ``n_heads``,
  quant (step 8), ``adafactor`` / ``bfloat16_sr`` (step 9, also under pp),
  ep, a quantized model under pp (step 8), an int4 row shard tp cannot cut,
  and generate's mesh flags without ``--distributed``. Dropout under tp and
  LRA on a tp mesh build (their runs: tests/test_torch_mesh_dropout.py,
  tests/test_torch_lra_mesh.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
import torch_tp_workers as tp_workers
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.parallel import sharding as jax_sharding
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig, make_mesh
from orion_tpu_torch.convert import expected_params
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel import sharding
from orion_tpu_torch.parallel.mesh import Mesh, MeshConfig

TINY = dict(name="tp_test", vocab_size=64, d_model=32, n_layers=2, n_heads=2, max_seq_len=64,
            dtype="float32")
CONFIGS = {
    "tiny": dict(TINY),
    "hybrid": dict(TINY, n_layers=3, layer_types=("linear", "softmax", "swa"), window=6),
    "moe": dict(TINY, n_experts=4, moe_period=2),
    "learnable_untied": dict(TINY, feature_map="learnable", tie_embeddings=False),
    "odd_hidden": dict(TINY, mlp_hidden=45),
}
GROUP_MESHES = [MeshConfig(dp=1, fsdp=2, tp=2), MeshConfig(dp=2, tp=2),
                MeshConfig(dp=1, tp=2, sp=2)]
ROUND_TRIP = [MeshConfig(dp=1, fsdp=2, tp=2), MeshConfig(dp=1, tp=2, sp=2)]
TRIP_MODEL = dict(TINY, n_layers=3, n_heads=4, layer_types=("linear", "softmax", "linear"),
                  feature_map="learnable", tie_embeddings=False, n_experts=4, moe_period=3)


@functools.lru_cache(maxsize=None)
def _jax_abstract(name):
    jcfg = JaxModelConfig(**CONFIGS[name])
    return jax.eval_shape(lambda: JaxLM(jcfg).init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 8), jnp.int32)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, path + "/"))
        else:
            out[path] = v
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_tp_table_matches_jax_param_shardings(name):
    """Which leaves tp cuts, and along which dimension in the port's layout:
    the JAX package's clipped spec on a dp=1, tp=2 mesh (the leaves of
    ``TP_WHOLE`` held whole instead)."""
    import re

    cfg = ModelConfig(**CONFIGS[name])
    specs = _flat(dict(jax_sharding.param_shardings(
        _jax_abstract(name), make_mesh(JaxMeshConfig(dp=1, tp=2)))["params"]))
    table = sharding.tp_dims(cfg, 2)
    whole = 0
    for path, (key, shape, transpose) in expected_params(cfg).items():
        spec = tuple(specs[path].spec)
        if "tp" in spec and any(re.search(p, path) for p in sharding.TP_WHOLE):
            assert key not in table, path
            whole += 1
            continue
        if "tp" not in spec:
            assert key not in table, path
            continue
        i = spec.index("tp")
        assert table[key] == (len(shape) - 1 - i if transpose else i), path
    # two phi_proj and the untied head
    assert whole == (3 if name == "learnable_untied" else 0)
    if name == "odd_hidden":  # the MLP runs whole: neither side cuts it
        assert not any(k.startswith("blocks.0.mlp") for k in table)
    assert sharding.tp_dims(cfg, 1) == {}


def test_tp_must_divide_the_heads():
    with pytest.raises(ValueError, match="n_heads"):
        sharding.tp_dims(ModelConfig(**dict(TINY, n_heads=3, d_model=48)), 2)


@pytest.fixture(scope="module")
def ranks():
    rng = np.random.default_rng(5)
    payload = {
        "mesh": GROUP_MESHES[0],
        "meshes": GROUP_MESHES,
        "round_trip": ROUND_TRIP,
        "model": ModelConfig(**TRIP_MODEL),
        "dtypes": ["float32", "bfloat16"],
        "x": rng.standard_normal((2, 3, 8)).astype(np.float32),
        "ct": rng.standard_normal((2, 3, 8)).astype(np.float32),
    }
    return workers.run_ranks(4, tp_workers.rules_and_groups, payload)


@pytest.mark.parametrize("i", range(len(GROUP_MESHES)),
                         ids=[str(m.shape[:4]) for m in GROUP_MESHES])
def test_rank_coordinates_and_groups_match_the_jax_mesh(ranks, i):
    cfg = GROUP_MESHES[i]
    jmesh = make_mesh(JaxMeshConfig(dp=cfg.dp, fsdp=cfg.fsdp, tp=cfg.tp, sp=cfg.sp))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(cfg.dp, cfg.fsdp, cfg.tp, cfg.sp)
    axes = {"dp_group": (0,), "fsdp_group": (1,), "tp_group": (2,), "sp_group": (3,),
            "data_group": (0, 1), "replica_group": (0, 1, 3),
            "shard_group": (0, 3) if cfg.fsdp > 1 else None}
    for rank, res in enumerate(ranks):
        coords, groups = res["groups"][i]
        assert ids[coords] == rank
        for name, varying in axes.items():
            if varying is None:
                assert groups[name] is None, name
                continue
            index = tuple(slice(None) if a in varying else c for a, c in enumerate(coords))
            want = sorted(int(r) for r in ids[index].reshape(-1))
            assert groups[name] == (want if len(want) > 1 else None), (name, rank)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_copy_to_tp_and_reduce_from_tp(ranks, dtype):
    """copy: identity forward, the cotangents summed backward; reduce: the
    partial inputs summed forward (in fp32, rounded once), identity
    backward. Every rank of a tp group holds the same bits."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)  # the payload's draws
    xs = rng.standard_normal((2, 3, 8)).astype(np.float32)
    cts = rng.standard_normal((2, 3, 8)).astype(np.float32)
    xq = torch.from_numpy(xs).to(dt).float()
    want_sum = (xq[0] + xq[1]).to(dt).float().numpy()
    tol = dict(rtol=1e-6, atol=1e-6)
    for rank, res in enumerate(ranks):
        t = res["groups"][0][0][2]  # the spawn's mesh: (1, 2, 2, 1)
        copy_out, copy_grad, red_out, red_grad = res["collectives"][dtype]
        np.testing.assert_array_equal(copy_out, xq[t].numpy())
        ctq = torch.from_numpy(cts).to(dt).float()  # each rank's cotangent in x's dtype
        np.testing.assert_array_equal(copy_grad, (ctq[0] + ctq[1]).to(dt).float().numpy())
        np.testing.assert_array_equal(red_out, want_sum)
        np.testing.assert_allclose(red_grad, torch.from_numpy(cts[t]).to(dt).float(), **tol)


@pytest.mark.parametrize("i", range(len(ROUND_TRIP)), ids=[str(m.shape[:4]) for m in ROUND_TRIP])
def test_cut_then_gathered_is_bitwise_the_whole_model(ranks, i):
    from orion_tpu_torch.models.transformer import TransformerLM

    cfg = ModelConfig(**TRIP_MODEL)
    whole = TransformerLM(cfg, device="cpu").state_dict()
    table = sharding.tp_dims(cfg, 2)
    assert any(k.endswith("experts_down") for k in table)
    for res in ranks:
        same, back, shapes = res["round_trip"][i]
        assert same
        assert back.keys() == whole.keys()
        for n, t in whole.items():
            np.testing.assert_array_equal(back[n], t.numpy(), err_msg=n)
        for n, d in table.items():  # the tp leaves are held as halves (fsdp cuts another dim)
            assert shapes[n][d] * 2 == whole[n].shape[d], n


@pytest.mark.parametrize("cfg", [MeshConfig(dp=2, tp=2), MeshConfig(dp=1, fsdp=2, tp=2, sp=2)],
                         ids=["dp2 tp2", "fsdp2 tp2 sp2"])
def test_the_tp_ranks_of_a_data_rank_read_the_same_rows_and_tokens(cfg):
    """A rank's rows (the loader's ``rows``) and token shard depend on its
    (d, f) and s only: every tp rank of them reads the same."""
    x = torch.arange(8 * 16).view(8, 16)
    seen = {}
    for rank in range(cfg.dp * cfg.fsdp * cfg.tp * cfg.sp):
        m = _mesh(cfg, rank)
        d, f, _, s = m.coords
        got = (m.row_index(8, 2).tolist(), m.shard(m.rows(x, 2)).tolist())
        assert seen.setdefault((d, f, s), got) == got
    assert len(seen) == cfg.dp * cfg.fsdp * cfg.sp


# -- refusals ------------------------------------------------------------------


def _mesh(cfg, rank=0):
    """This rank's ``Mesh`` of ``cfg`` without a process group (building a
    model or a trainer refuses before any collective)."""
    world = cfg.dp * cfg.fsdp * cfg.tp * cfg.sp
    return Mesh(cfg, rank, world, torch.device("cpu"), "gloo", None)


def test_dropout_quant_and_odd_heads_under_tp_raise():
    from orion_tpu_torch.models.transformer import TransformerLM

    mesh = _mesh(MeshConfig(dp=1, tp=2))
    # dropout under tp builds (its masks are every tp rank's alike: the
    # runs are in tests/test_torch_mesh_dropout.py); each rank its heads
    model = TransformerLM(ModelConfig(**dict(TINY, dropout=0.1)), device="cpu", mesh=mesh)
    assert model.blocks[0].attn.heads == TINY["n_heads"] // 2
    # a quantized model under tp is ported (tests/test_torch_genmesh_quant.py);
    # int4 refuses a row shard whose packed rows tp does not divide: hidden
    # 66 splits over tp 2, its 33 packed rows of down do not
    TransformerLM(ModelConfig(**TINY), device="cpu", mesh=mesh, quant="int8")
    with pytest.raises(ValueError, match="blocks.0.mlp.down.weight_p4"):
        TransformerLM(ModelConfig(**dict(TINY, mlp_hidden=66)), device="cpu", mesh=mesh,
                      quant="int4")
    with pytest.raises(ValueError, match="n_heads"):
        TransformerLM(ModelConfig(**dict(TINY, n_heads=1)), device="cpu", mesh=mesh)


@pytest.mark.parametrize("kw", [dict(optimizer="adafactor"), dict(param_storage="bfloat16_sr")])
def test_adafactor_and_bf16_sr_under_tp_raise_naming_step_9(kw):
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=ModelConfig(**TINY), mesh=MeshConfig(dp=1, tp=2), batch_size=4,
                      seq_len=16, **kw)
    with pytest.raises(NotImplementedError, match="item 12.*A12 step 9"):
        Trainer(cfg, mesh=Mesh(cfg.mesh, 0, 4, torch.device("cpu"), "gloo", None))


@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_pp_and_ep_still_raise(axis):
    """ep raises for any use; pp is ported (tests/test_torch_pp*.py) and what
    it still refuses raises: ``adafactor`` under pp x dp (A12 step 9)."""
    if axis == "ep":
        with pytest.raises(NotImplementedError, match="item 12"):
            MeshConfig(dp=1, **{axis: 2}).check()
        return
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=ModelConfig(**TINY), mesh=MeshConfig(dp=2, pp=2),
                      batch_size=4, seq_len=16, optimizer="adafactor")
    with pytest.raises(NotImplementedError, match="under pp .*item 12.*A12 step 9"):
        Trainer(cfg, mesh=Mesh(cfg.mesh, 0, 4, torch.device("cpu"), "gloo", None))


def test_lra_on_a_tp_mesh_raises_naming_step_7():
    """LRA on a tp mesh is ported (tests/test_torch_lra_mesh.py): the
    classifier builds with half the heads a rank and its head whole;
    ``train_lra`` without the mesh's process group raises, and so does
    ``adafactor`` under tp, naming A12 step 9."""
    from orion_tpu_torch.models.classifier import LRAClassifier
    from orion_tpu_torch.models.configs import get_config
    from orion_tpu_torch.train_lra import LRATrainConfig, train_lra

    model_cfg = get_config("lra_listops_linear")
    cfg = LRATrainConfig(model=model_cfg, mesh=MeshConfig(dp=1, tp=2))
    with pytest.raises(ValueError, match="init_distributed"):
        train_lra(cfg, device="cpu")
    mesh = _mesh(MeshConfig(dp=1, tp=2))
    clf = LRAClassifier(model_cfg, device="cpu", mesh=mesh)
    assert clf.blocks[0].attn.wq.weight.shape[0] == model_cfg.d_model // 2
    assert clf.head.weight.shape == (model_cfg.n_classes, model_cfg.d_model)
    with pytest.raises(NotImplementedError, match="item 12.*A12 step 9"):
        train_lra(dataclasses.replace(cfg, optimizer="adafactor"), device="cpu", mesh=mesh)


@pytest.mark.parametrize("flag,step", [("--sp", "A12 step 6 "), ("--dp", "A12 step 6b"),
                                       ("--fsdp", "A12 step 6b")])
def test_generate_refuses_the_mesh_flags_it_does_not_port(flag, step):
    """Each mesh flag is ported (``step`` ported it: tests/test_torch_genmesh*.py);
    without ``--distributed`` it is refused, for want of its process group."""
    from orion_tpu_torch.generate import main

    with pytest.raises(ValueError, match=f"{flag} 2 needs its process group") as err:
        main(["--device", "cpu", flag, "2"])
    assert step not in str(err.value)


def test_generate_tp_needs_distributed():
    from orion_tpu_torch.generate import main

    with pytest.raises(ValueError, match="--distributed"):
        main(["--device", "cpu", "--tp", "2"])


def test_generate_quant_under_tp_raises_naming_step_8():
    """Quantizing under tp is ported (tests/test_torch_genmesh_quant.py);
    what still refuses names step 8: a quantized model under pp."""
    from orion_tpu_torch.generate import quantize_for_decode

    model = dataclasses.make_dataclass("M", [("quant", str), ("cfg", object), ("device", object),
                                             ("mesh", object)])(
        "", ModelConfig(**TINY), torch.device("cpu"), _mesh(MeshConfig(dp=1, tp=2, pp=2)))
    with pytest.raises(NotImplementedError, match="under pp.*A12 step 8"):
        quantize_for_decode(model, "int8")
