"""The port's Trainer on two gloo CPU ranks (dp 2, fsdp 2) held against the
JAX package's Trainer, and its checkpoints across meshes, on the CPU.

One spawn (``tests/torch_sp_workers.py``'s ``mesh_runs``: processes that
import torch and the port, never JAX) runs every two-rank case, each on its
own mesh of the one process group:

- ``tests/test_sharding.py::test_trainer_parity_across_meshes``'
  configuration (linear + softmax, fp32) at dp 2 and at fsdp 2, two steps
  from the JAX Trainer's params on the same synthetic batches, against the
  JAX Trainer at ``MeshConfig(dp=1)`` and at the same mesh on the
  conftest's virtual CPU devices (the JAX test's tolerance: 2e-5 on the
  loss and every param);
- a tiny MoE (4 experts in block 1), capacity and dropless, at dp 2 with
  ``accum_steps=2``: the load-balance statistics averaged over the data
  group, each rank its rows of each micro-batch; loss and every param
  against the JAX Trainer (2e-5);
- Lion at dp 2 against the JAX Trainer (2e-5), and ``bfloat16_sr`` at dp 2
  against the port at dp=1 from the same seed: the same rounding keys, the
  bf16 gradients summed over two ranks in bf16, so within two bf16 steps
  plus 2^-7 of the largest update (``tests/test_torch_model_options.py``'s
  rule);
- fsdp 2 for four steps saving at steps 2 and 4, then a fresh fsdp-2
  trainer resumed at step 2: its params bitwise the uninterrupted run's.

In this process: the fsdp-2 checkpoint of step 2 restored on one device
and trained to step 4 equals the uninterrupted fsdp-2 run within 2e-5 (the
file is a dp=1 run's: same keys, shapes and manifest), and the step-4
checkpoint served by ``generate.load_model`` gives the greedy tokens of a
dp=1 run's checkpoint.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sp_workers as workers
from orion_tpu.models.configs import ModelConfig as JaxModelConfig
from orion_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from orion_tpu.training.data import SyntheticDataset
from orion_tpu.training.trainer import TrainConfig as JaxTrainConfig
from orion_tpu.training.trainer import Trainer as JaxTrainer
from orion_tpu_torch.convert import params_from_jax
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel.mesh import MeshConfig

_TOL = dict(rtol=2e-5, atol=2e-5)
SHARD = dict(name="shard_test", vocab_size=64, d_model=32, n_layers=2, n_heads=2, max_seq_len=64,
             dtype="float32", layer_types=("linear", "softmax"))
KW = dict(steps=2, batch_size=8, seq_len=16, lr=1e-3, warmup_steps=1, log_every=100)
MOE = dict(SHARD, name="moe_test", layer_types=("linear", "linear"), n_experts=4, moe_period=2,
           max_seq_len=64)
MOE_KW = dict(KW, seq_len=32, accum_steps=2)
CKPT_KW = dict(KW, steps=4)
DP2, FSDP2 = MeshConfig(dp=2), MeshConfig(dp=1, fsdp=2)


def _batches(n, seq_len=16, b=8):
    ds = SyntheticDataset(64, seq_len)
    return [np.asarray(ds.batch(0, i, b)) for i in range(n)]


def _jax_trainer(model, kw, mesh, **extra):
    return JaxTrainer(JaxTrainConfig(model=JaxModelConfig(backend="xla", **model, **extra),
                                     mesh=mesh, **kw))


def _steps(tr, batches):
    """The JAX Trainer's losses over ``batches`` and its final params tree."""
    losses = [float(tr.step(jnp.asarray(b))["loss"]) for b in batches]
    return losses, jax.device_get(tr.state.params)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("fsdp2_ckpt"))


@pytest.fixture(scope="module")
def runs(ckpt_dir):
    """{"jax": name -> (losses, final params tree), "port": name -> the
    ranks' results}. The ranks start from the JAX trainers' initial params
    (one seed: every SHARD trainer's are the same) and run while the JAX
    trainers step."""
    b16, b32, b4 = _batches(2), _batches(2, 32), _batches(4)
    jt = {"dp1": _jax_trainer(SHARD, KW, JaxMeshConfig(dp=1)),
          "moe capacity": _jax_trainer(MOE, MOE_KW, JaxMeshConfig(dp=1)),
          "moe dropless": _jax_trainer(MOE, MOE_KW, JaxMeshConfig(dp=1), moe_dropless=True)}
    trees = {n: jax.device_get(t.state.params) for n, t in jt.items()}
    port = {
        "dp2": dict(mesh=DP2, model=ModelConfig(**SHARD), tree=trees["dp1"], batches=b16),
        "fsdp2": dict(mesh=FSDP2, model=ModelConfig(**SHARD), tree=trees["dp1"], batches=b16),
        "moe capacity": dict(mesh=DP2, model=ModelConfig(**MOE), tree=trees["moe capacity"],
                             batches=b32, kw=MOE_KW),
        "moe dropless": dict(mesh=DP2, model=ModelConfig(**MOE, moe_dropless=True),
                             tree=trees["moe dropless"], batches=b32, kw=MOE_KW),
        "lion": dict(mesh=DP2, model=ModelConfig(**SHARD), tree=trees["dp1"], batches=b16,
                     kw=dict(optimizer="lion")),
        "bf16_sr": dict(mesh=DP2, model=ModelConfig(**SHARD), batches=b16,
                        kw=dict(param_storage="bfloat16_sr")),
        "fsdp2 save": dict(mesh=FSDP2, model=ModelConfig(**SHARD), batches=b4, kw=CKPT_KW,
                           ckpt=ckpt_dir, save_every=2),
        "fsdp2 resume": dict(mesh=FSDP2, model=ModelConfig(**SHARD), batches=b4[2:], kw=CKPT_KW,
                             ckpt=ckpt_dir, restore=2),
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(workers.run_ranks, 2, workers.mesh_runs,
                            {"mesh": DP2, "kw": KW, "runs": list(port.values())}, 240)
        jax_runs = {
            "dp1": _steps(jt["dp1"], b16),
            "dp2": _steps(_jax_trainer(SHARD, KW, JaxMeshConfig(dp=2)), b16),
            "fsdp2": _steps(_jax_trainer(SHARD, KW, JaxMeshConfig(dp=1, fsdp=2)), b16),
            "moe capacity": _steps(jt["moe capacity"], b32),
            "moe dropless": _steps(jt["moe dropless"], b32),
            "lion": _steps(_jax_trainer(SHARD, dict(KW, optimizer="lion"), JaxMeshConfig(dp=1)),
                           b16),
        }
        ranks = ranks.result()
    return {"jax": jax_runs, "port": {name: [r[i] for r in ranks] for i, name in enumerate(port)}}


def _check(ranks, losses, params_tree, model):
    ref = params_from_jax(params_tree, model)
    for r_losses, _, params, _ in ranks:
        np.testing.assert_allclose(r_losses, losses, **_TOL)
        for n, p in params.items():
            np.testing.assert_allclose(p, ref[n].numpy(), **_TOL, err_msg=n)
    for _, _, params, _ in ranks[1:]:  # the ranks agree bitwise
        for n, p in params.items():
            np.testing.assert_array_equal(p, ranks[0][2][n], err_msg=n)


@pytest.mark.parametrize("mesh", ["dp2", "fsdp2"])
@pytest.mark.parametrize("ref", ["dp1", "same mesh"])
def test_one_step_on_a_mesh_equals_the_jax_trainer(runs, mesh, ref):
    losses, params = runs["jax"]["dp1" if ref == "dp1" else mesh]
    _check(runs["port"][mesh], losses, params, ModelConfig(**SHARD))


@pytest.mark.parametrize("form", ["capacity", "dropless"])
def test_a_moe_with_accumulation_at_dp2_matches_the_jax_trainer(runs, form):
    losses, params = runs["jax"][f"moe {form}"]
    model = ModelConfig(**MOE, moe_dropless=form == "dropless")
    _check(runs["port"][f"moe {form}"], losses, params, model)


def test_lion_at_dp2_matches_the_jax_trainer(runs):
    losses, params = runs["jax"]["lion"]
    _check(runs["port"]["lion"], losses, params, ModelConfig(**SHARD))


def test_bf16_sr_at_dp2_is_within_two_bf16_steps_of_one_device(runs):
    port = runs["port"]
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    one = Trainer(TrainConfig(model=ModelConfig(**SHARD), param_storage="bfloat16_sr", **KW),
                  device="cpu")
    init = {n: p.detach().float().clone() for n, p in one.params.items()}
    for b in _batches(2):
        one.step(torch.from_numpy(b).long())
    for _, _, params, _ in port["bf16_sr"]:
        for n, p in one.params.items():
            got, ref = torch.from_numpy(params[n]), p.detach().float()
            if p.dtype == torch.bfloat16:
                step = torch.maximum(got.abs(), ref.abs()) * 2.0 ** -7
                moved = (ref - init[n]).abs()
                assert bool(((got - ref).abs() <= 2 * step + 2.0 ** -7 * moved.max()).all()), n
            else:
                torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5, msg=n)
    assert port["bf16_sr"][0][3]["blocks.0.attn.wq.weight"] == "torch.bfloat16"


def test_same_mesh_resume_at_fsdp2_is_bitwise(runs):
    whole, resumed = runs["port"]["fsdp2 save"], runs["port"]["fsdp2 resume"]
    assert [r[0][2:] for r in whole] == [r[0] for r in resumed]
    for (_, _, a, _), (_, _, b, _) in zip(whole, resumed):
        for n in a:
            np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_an_fsdp2_checkpoint_is_the_dp1_file_and_restores_on_one_device(runs, ckpt_dir):
    """Restored on one device at step 2 and trained to 4: the uninterrupted
    fsdp-2 run's params within 2e-5; the file's keys and shapes are a dp=1
    trainer's, moments included."""
    from orion_tpu_torch.training.checkpoint import Checkpointer, read_manifest
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=ModelConfig(**SHARD), **CKPT_KW)
    one = Trainer(cfg, device="cpu")
    want = one.state_dict()
    state = torch.load(f"{ckpt_dir}/step-00000002.pt", map_location="cpu")
    for key in ("params", "opt"):
        flat = {k: v for k, v in state[key].items() if torch.is_tensor(v)}
        ref = {k: v for k, v in want[key].items() if torch.is_tensor(v)}
        assert flat.keys() == ref.keys()
    for sub in ("params",):
        assert {n: t.shape for n, t in state[sub].items()} == \
            {n: t.shape for n, t in want[sub].items()}
    for m in ("mu", "nu"):
        assert {n: t.shape for n, t in state["opt"][m].items()} == \
            {n: t.shape for n, t in want["opt"][m].items()}
    assert read_manifest(ckpt_dir, 2) is not None
    start = one.restore(Checkpointer(ckpt_dir), 2)
    assert start == 2
    for b in _batches(4)[2:]:
        one.step(torch.from_numpy(b).long())
    for n, p in runs["port"]["fsdp2 save"][0][2].items():
        np.testing.assert_allclose(one.params[n].detach().numpy(), p, **_TOL, err_msg=n)


def test_an_fsdp2_checkpoint_serves_the_dp1_checkpoints_greedy_tokens(runs, ckpt_dir, tmp_path):
    from orion_tpu_torch.generate import generate, load_model
    from orion_tpu_torch.training.checkpoint import Checkpointer
    from orion_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=ModelConfig(**SHARD), **CKPT_KW)
    one = Trainer(cfg, device="cpu")
    ck = Checkpointer(str(tmp_path), save_every=4)
    for b in _batches(4):
        one.step(torch.from_numpy(b).long())
        one._save(ck, one.step_count)
    prompt = torch.from_numpy(_batches(1, 12, 2)[0]).long()
    tokens = []
    for d in (ckpt_dir, str(tmp_path)):
        model, step = load_model(cfg.model, d, "cpu", step=4)
        assert step == 4
        tokens.append(generate(model, prompt, 8))
    torch.testing.assert_close(tokens[0], tokens[1], rtol=0, atol=0)
