"""The data axes of the port's mesh (dp, fsdp) held against the JAX
package, on the CPU: the rank layout and each rank's rows, the sharding
table, the collectives fsdp and the MoE's statistics use, the loader's rank
rows, and what this slice refuses.

- Rank layout: ``parallel.mesh.Mesh``'s coordinates and row blocks against
  the JAX mesh's device order and ``NamedSharding(mesh, P(("dp",
  "fsdp"))).devices_indices_map`` at dp 2 x fsdp 2 x sp 2 (the conftest's
  eight virtual CPU devices), and each micro-batch's blocks against the
  same map on the JAX Trainer's micro-batch reshape.
- The sharding table (``parallel/sharding.py``): every leaf's rule against
  ``orion_tpu.parallel.sharding.spec_for_path``, and which leaves shard
  along which dimension against ``param_shardings`` at fsdp 2 and 4, for
  ``tiny``, a hybrid, a MoE and the learnable / untied options.
- The collectives: one spawn of four gloo ranks (``tests/torch_sp_workers.py``,
  a dp 2 x fsdp 2 mesh) runs ``all_gather``, ``reduce_scatter`` and
  ``all_reduce_mean`` over its dp group (2 ranks) and its data group (4),
  forward and backward, against sums of numpy arrays (fp32, 1e-6).
- The loader: a rank's rows of each dataset bitwise the JAX package's
  global batch's rows, and a token-bin dataset reads only their windows.
- The refusals: ep (tp and pp are ported and need their process group),
  quant on a data mesh (a dropout model builds there and draws its rows'
  slice of the one-rank masks),
  ``adafactor`` and ``bfloat16_sr`` under fsdp (``NotImplementedError``
  naming item 12), ``adafactor_fused`` on two ranks beside the JAX Trainer
  raising for the same mesh, an axis above 1 without a process group.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_sp_workers as workers
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.models.transformer import TransformerLM as JaxLM
from orion_tpu.parallel import sharding as jax_sharding
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig, make_mesh
from orion_tpu.training import data as jax_data
from orion_tpu_torch.convert import expected_params
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel import sharding
from orion_tpu_torch.parallel.mesh import Mesh, MeshConfig, row_index
from orion_tpu_torch.training import data

TINY = dict(name="dp_test", vocab_size=64, d_model=32, n_layers=2, n_heads=2, max_seq_len=64,
            dtype="float32")
CONFIGS = {
    "tiny": dict(TINY),
    "hybrid": dict(TINY, n_layers=3, layer_types=("linear", "softmax", "swa"), window=6),
    "moe": dict(TINY, n_experts=4, moe_period=2),
    "learnable_untied": dict(TINY, feature_map="learnable", tie_embeddings=False),
    "favor_gelu_layernorm": dict(TINY, feature_map="favor", mlp="gelu", norm="layernorm"),
}


def _mesh(cfg, rank):
    """This rank's ``Mesh`` of ``cfg`` without a process group (its
    coordinates and rows need none)."""
    world = cfg.dp * cfg.fsdp * cfg.sp
    return Mesh(cfg, rank, world, torch.device("cpu"), "gloo", None)


@pytest.mark.parametrize("accum", [1, 2])
def test_rank_layout_and_row_blocks_match_the_jax_mesh(accum):
    cfg = MeshConfig(dp=2, fsdp=2, sp=2)
    jmesh = make_mesh(JaxMeshConfig(dp=2, fsdp=2, sp=2))
    devices = jmesh.devices.reshape(2, 2, 2)  # tp, pp, ep are 1
    b, t = 16, 8
    micro = b // accum
    index = NamedSharding(jmesh, P(("dp", "fsdp"))).devices_indices_map((micro, t))
    for rank in range(8):
        m = _mesh(cfg, rank)
        d, f, t, s = m.coords
        assert t == 0 and devices[d, f, s].id == rank
        assert (m.dp_rank, m.fsdp_rank, m.sp_rank, m.data_rank) == (d, f, s, d * 2 + f)
        sl = index[devices[d, f, s]][0]
        want = np.concatenate([np.arange(i * micro + sl.start, i * micro + sl.stop)
                               for i in range(accum)])
        np.testing.assert_array_equal(m.row_index(b, accum), want)
        x = torch.arange(b * 3).view(b, 3)
        np.testing.assert_array_equal(m.rows(x, accum).numpy(), x.numpy()[want])


def test_row_index_refuses_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="row blocks"):
        row_index(6, 4, 0)
    with pytest.raises(ValueError, match="row blocks"):
        row_index(8, 4, 0, accum=4)


@functools.lru_cache(maxsize=None)
def _jax_abstract(name):
    jcfg = JaxModelConfig(**CONFIGS[name])
    return jax.eval_shape(lambda: JaxLM(jcfg).init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 8), jnp.int32)))


def _flat_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_paths(v, path + "/"))
        else:
            out[path] = v
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_rule_matches_the_jax_spec_for_path(name):
    paths = expected_params(ModelConfig(**CONFIGS[name]))
    assert set(paths) == set(_flat_paths(dict(_jax_abstract(name)["params"])))
    for path in paths:
        assert sharding.spec_for_path(path) == tuple(jax_sharding.spec_for_path(path)), path
    for path in ("blocks_stacked/block_0/attn/wq/kernel", "blocks_stacked/block_0/norm1/scale"):
        assert sharding.spec_for_path(path) == tuple(jax_sharding.spec_for_path(path))


@pytest.mark.parametrize("fsdp", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_fsdp_table_matches_jax_param_shardings(name, fsdp):
    """Which leaves shard, and along which dimension in the port's layout:
    the JAX package's clipped spec on a dp=1, fsdp=n mesh."""
    cfg = ModelConfig(**CONFIGS[name])
    jmesh = make_mesh(JaxMeshConfig(dp=1, fsdp=fsdp))
    specs = _flat_paths(dict(jax_sharding.param_shardings(_jax_abstract(name), jmesh)["params"]))
    table = sharding.fsdp_dims(cfg, fsdp)
    for path, (key, shape, transpose) in expected_params(cfg).items():
        spec = tuple(specs[path].spec)
        if "fsdp" not in spec:
            assert key not in table, (path, spec)
            continue
        i = spec.index("fsdp")
        assert table[key] == (1 - i if transpose else i), (path, spec)
        assert shape[table[key]] % fsdp == 0
    assert sharding.fsdp_dims(cfg, 1) == {}


def test_a_dimension_the_fsdp_size_does_not_divide_stays_replicated():
    cfg = ModelConfig(**dict(TINY, d_model=36, n_heads=2))  # every fsdp dim is d: 36 % 8 != 0
    assert sharding.fsdp_dims(cfg, 8) == {}
    table = sharding.fsdp_dims(cfg, 4)
    assert table["embed.weight"] == 1 and table["blocks.0.attn.wq.weight"] == 1
    assert table["blocks.0.attn.wo.weight"] == 0 and "blocks.0.norm1.weight" not in table


def test_shard_and_gather_leaf_on_one_process():
    full = torch.arange(24.0).view(4, 6)
    shards = [sharding.shard_leaf(full, 1, 3, i) for i in range(3)]
    assert all(s.shape == (4, 2) for s in shards)
    torch.testing.assert_close(torch.cat(shards, 1), full, rtol=0, atol=0)


def _collective_payload():
    rng = np.random.default_rng(21)
    draw = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    payload = {"x": draw(4, 4, 6), "y": draw(4, 8, 12), "groups": ["dp_group", "data_group"],
               "mesh": MeshConfig(dp=2, fsdp=2)}
    # a cotangent for each global rank, shaped as the output on a group of
    # up to four ranks (the dp group's outputs take the first rows)
    payload.update({"ct_gather0": draw(4, 16, 6), "ct_gather1": draw(4, 4, 24),
                    "ct_mean": draw(4, 4, 6)})
    return payload


@functools.lru_cache(maxsize=None)
def _collectives():
    return workers.run_ranks(4, workers.collective_cases, _collective_payload())


def _members(group):
    """The global ranks of each group of the dp 2 x fsdp 2 mesh, in
    group-rank order, by the group of rank r."""
    if group == "dp_group":  # ranks with the same f
        return {r: [r % 2, r % 2 + 2] for r in range(4)}
    return {r: [0, 1, 2, 3] for r in range(4)}


@pytest.mark.parametrize("case", ["gather0", "gather1", "mean", "scatter0", "scatter1"])
@pytest.mark.parametrize("group", ["dp_group", "data_group"])
def test_collective_matches_its_single_process_sum(group, case):
    payload = _collective_payload()
    ranks = _collectives()
    for r in range(4):
        me, res = ranks[r][group]
        members = _members(group)[r]
        n = len(members)
        assert members[me] == r
        out, grad = res[case]
        key = "y" if case.startswith("scatter") else "x"
        xs = [payload[key][i] for i in range(n)]  # group rank i holds row i
        cts = [payload["ct_" + case][g] for g in members] if grad is not None else None
        if case.startswith("gather"):
            dim = int(case[-1])
            np.testing.assert_array_equal(out, np.concatenate(xs, dim))
            shape = out.shape
            want = sum(c[:shape[0], :shape[1]] for c in cts)
            np.testing.assert_allclose(grad, np.split(want, n, dim)[me], rtol=1e-6, atol=1e-6)
        elif case == "mean":
            np.testing.assert_allclose(out, sum(xs) / n, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(grad, sum(cts) / n, rtol=1e-6, atol=1e-6)
        else:
            dim = int(case[-1])
            np.testing.assert_allclose(out, np.split(sum(xs), n, dim)[me], rtol=1e-6, atol=1e-6)


def _token_bin(tmp_path):
    path = str(tmp_path / "toks.bin")
    toks = (np.arange(5000) * 7919) % 251
    jax_data.write_token_bin(path, toks, vocab_size=251)
    shards = []
    for i, part in enumerate(np.array_split(toks, 3)):
        p = str(tmp_path / f"shard_{i:03d}.bin")
        jax_data.write_token_bin(p, part, vocab_size=251)
        shards.append(p)
    return path, shards


@pytest.mark.parametrize("accum", [1, 2])
def test_a_ranks_rows_are_bitwise_the_global_batchs(tmp_path, accum):
    path, shards = _token_bin(tmp_path)
    pairs = [
        (data.TokenBinDataset(path, 16), jax_data.TokenBinDataset(path, 16)),
        (data.ShardedTokenBinDataset(shards, 16), jax_data.ShardedTokenBinDataset(shards, 16)),
        (data.SyntheticDataset(251, 16), jax_data.SyntheticDataset(251, 16)),
    ]
    cfg = MeshConfig(dp=2, fsdp=2)
    for ours, ref in pairs:
        for step in (0, 5):
            full = np.asarray(ref.batch(3, step, 8))
            for rank in range(4):
                rows = _mesh(cfg, rank).row_index(8, accum)
                np.testing.assert_array_equal(ours.batch(3, step, 8, rows=rows), full[rows])
                got = data.device_batch(ours, 3, step, 8, "cpu", rows)
                np.testing.assert_array_equal(got.numpy(), full[rows])


def test_a_token_bin_rank_reads_only_its_windows(tmp_path, monkeypatch):
    path, _ = _token_bin(tmp_path)
    ds = data.TokenBinDataset(path, 16)
    read = []
    real = ds.gather
    monkeypatch.setattr(ds, "gather", lambda starts: read.append(len(starts)) or real(starts))
    rows = _mesh(MeshConfig(dp=2, fsdp=2), 3).row_index(8)
    loader = data.DataLoader(ds, 8, seed=1, rows=rows)
    try:
        batch = next(loader)
    finally:
        loader.close()
    assert batch.shape == (2, 17) and set(read) == {2}


# -- refusals ------------------------------------------------------------------


def test_tp_pp_and_ep_above_1_raise_naming_item_12():
    # ep is not ported; tp and pp are (tests/test_torch_tp*.py,
    # tests/test_torch_pp*.py) and raise only without their process group
    with pytest.raises(NotImplementedError, match="item 12"):
        MeshConfig(dp=1, ep=2).check()
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    for axis in ("tp", "pp"):
        with pytest.raises(ValueError, match="init_distributed"):
            Trainer(TrainConfig(model=ModelConfig(**TINY), mesh=MeshConfig(dp=1, **{axis: 2}),
                                batch_size=4, seq_len=16), device="cpu")
    for cfg in (MeshConfig(dp=2), MeshConfig(dp=1, fsdp=2, sp=2), MeshConfig(dp=2, fsdp=2, sp=2),
                MeshConfig(dp=1, tp=2), MeshConfig(dp=2, fsdp=2, tp=2, sp=2),
                MeshConfig(dp=1, pp=2), MeshConfig(dp=2, fsdp=2, tp=2, sp=2, pp=2)):
        cfg.check()


def test_dropout_and_quant_on_a_data_mesh_raise_naming_item_12():
    """Dropout on a data mesh is ported: the model builds on both meshes,
    and at dp 2 rank 1's features with dropout are the one-rank run's rows
    2..3 (its masks the one-rank masks' slice: tests/test_torch_mesh_dropout.py
    holds the training runs). A quantized model's serving pieces under fsdp
    still raise, naming A12 step 8."""
    from orion_tpu_torch.models.transformer import TransformerLM

    drop = ModelConfig(**dict(TINY, dropout=0.1, dtype="float32"))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, TINY["vocab_size"], (4, 16)))
    with torch.no_grad():
        one, _ = TransformerLM(drop, device="cpu").features(tokens, False, 77)
    for mesh_cfg in (MeshConfig(dp=2), MeshConfig(dp=1, fsdp=2)):
        mesh = _mesh(mesh_cfg, 1 if mesh_cfg.dp == 2 else 0)
        model = TransformerLM(drop, device="cpu", mesh=mesh)
        if mesh_cfg.dp == 2:  # no collective in a dense dp model's forward
            with torch.no_grad():
                mine, _ = model.features(tokens[2:], False, 77)
            np.testing.assert_allclose(mine.numpy(), one[2:].numpy(), rtol=1e-6, atol=1e-6)
        # a quantized model on a data mesh serves generate
        # (tests/test_torch_genmesh_quant.py); under fsdp the serving
        # engine's pieces still raise, naming step 8
        model = TransformerLM(ModelConfig(**TINY), device="cpu", mesh=mesh, quant="int8")
        if mesh_cfg.fsdp > 1:
            with pytest.raises(NotImplementedError, match="item 12.*A12 step 8"):
                model.prefill_extend_step(torch.zeros(1, 4, dtype=torch.long), [], 0, 4)


@pytest.mark.parametrize("kw", [dict(optimizer="adafactor"), dict(param_storage="bfloat16_sr")])
def test_adafactor_and_bf16_sr_under_fsdp_raise_naming_item_12(kw):
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=ModelConfig(**TINY), mesh=MeshConfig(dp=1, fsdp=2), batch_size=4,
                      seq_len=16, **kw)
    with pytest.raises(NotImplementedError, match="item 12"):
        Trainer(cfg, mesh=_mesh(cfg.mesh, 0))
    # on dp alone they run on the replicated leaves (building a trainer
    # calls no collective, so a mesh without a process group will do)
    dp = dataclasses.replace(cfg, mesh=MeshConfig(dp=2))
    Trainer(dp, mesh=_mesh(dp.mesh, 0))


@pytest.mark.parametrize("mesh_cfg", [MeshConfig(dp=2), MeshConfig(dp=1, sp=2)],
                         ids=["dp2", "sp2"])
def test_adafactor_fused_on_two_ranks_raises_as_the_jax_trainer(mesh_cfg):
    from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
    from orion_tpu.training.trainer import Trainer as JaxTrainer
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    model = dict(TINY, sequence_parallel=mesh_cfg.sp > 1)
    kw = dict(batch_size=4, seq_len=16, optimizer="adafactor_fused")
    jmesh = JaxMeshConfig(dp=mesh_cfg.dp, sp=mesh_cfg.sp)
    with pytest.raises(ValueError, match="single-device meshes only") as jax_err:
        JaxTrainer(JaxTrainConfig(model=JaxModelConfig(**model), mesh=jmesh, **kw))
    with pytest.raises(ValueError, match="single-device meshes only") as err:
        Trainer(TrainConfig(model=ModelConfig(**model), mesh=mesh_cfg, **kw),
                mesh=_mesh(mesh_cfg, 0))
    for text in ("optimizer='adafactor_fused' runs on single-device meshes only",
                 "use optimizer='adafactor' on multi-device meshes"):
        assert text in str(jax_err.value) and text in str(err.value)


def test_an_axis_above_1_without_a_process_group_raises():
    from orion_tpu_torch.train import main
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    for cfg in (MeshConfig(dp=2), MeshConfig(dp=1, fsdp=2)):
        with pytest.raises(ValueError, match="init_distributed"):
            Trainer(TrainConfig(model=ModelConfig(**TINY), mesh=cfg, batch_size=4, seq_len=16),
                    device="cpu")
    with pytest.raises(ValueError, match="init_distributed"):
        main(["--config", "tiny", "--device", "cpu", "--dp", "2", "--steps", "1",
              "--seq-len", "16", "--batch-size", "4"])


def test_a_batch_the_data_ranks_do_not_divide_raises():
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = MeshConfig(dp=2, fsdp=2)
    for kw in (dict(batch_size=6), dict(batch_size=8, accum_steps=4)):
        with pytest.raises(ValueError, match="dp \\* fsdp"):
            Trainer(TrainConfig(model=ModelConfig(**TINY), mesh=cfg, seq_len=16, **kw),
                    mesh=_mesh(cfg, 0))
