"""Dropout on every mesh, on gloo CPU ranks (``tests/torch_combo_workers.py``:
one 2-rank and one 4-rank spawn; the one-rank run in this process).

A block's dropout masks are a function of its key and the position
(``models/transformer.py``'s ``dropout_keep``: the block's seed, the global
row, the global token, the feature), so a rank of any mesh draws its slice
of the one-rank masks. The model: linear and swa layers (window 4), d 32, 2
heads, fp32, ``dropout=0.1``, every block recomputed in the backward
(``remat_skip=0``), two AdamW steps on B 8 x 16.

- sp 2, dp 2, fsdp 2, tp 2 and dp 2 x tp 2 against the port's one-rank run:
  every mask each rank draws is bitwise the one-rank mask's slice at the
  rank's rows and tokens (under tp every rank the whole features), each
  step's loss within 2e-5 and the params after two steps within 3e-5 (the
  mesh trainer tests' tolerances).
- pp 2 x dp 2 against pp 2 (the pipeline's masks are its own, keyed per
  microbatch and stage as the JAX package folds its keys, so the twin is
  the pp run without the data axis): the same checks.
- Every recomputation redraws the mask its forward drew (the tap sees each
  key twice, equal).
- ``dropout_keep`` itself: the same key reproduces, another seed, site, row
  or token differs, the keep share is within six binomial standard
  deviations of 1 - rate, and kept values are scaled by 1 / (1 - rate).
- ``utils/rng.py``'s ``counter_below`` (the mask's int32 hash) is bitwise
  ``counter_bits`` (the int64 form sampling and rounding use) below the
  bound, at bounds across the words' range and keys with high bits set.
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

import torch_combo_workers as combo
import torch_sp_workers as workers
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel.mesh import MeshConfig

KW = dict(steps=2, batch_size=8, seq_len=16, lr=1e-3, warmup_steps=1, log_every=100)
MODEL = ModelConfig(name="drop_test", vocab_size=64, d_model=32, n_layers=4, n_heads=2,
                    max_seq_len=64, dtype="float32", layer_types=("linear", "swa") * 2, window=4,
                    dropout=0.1, remat=True, remat_skip=0, sequence_parallel=True)
PP_KW = {"pp_microbatches": 2}
# (label, mesh, world, the twin: "one" or the label of a run)
MESHES = (("sp2", dict(sp=2), 2, "one"), ("dp2", dict(dp=2), 2, "one"),
          ("fsdp2", dict(fsdp=2), 2, "one"), ("tp2", dict(tp=2), 2, "one"),
          ("pp2", dict(pp=2), 2, None), ("dp2 x tp2", dict(dp=2, tp=2), 4, "one"),
          ("pp2 x dp2", dict(dp=2, pp=2), 4, "pp2"))


def _batches():
    rng = np.random.default_rng(5)
    return [rng.integers(0, MODEL.vocab_size, (KW["batch_size"], KW["seq_len"] + 1))
            for _ in range(KW["steps"])]


def _run(mesh):
    return {"model": MODEL, "batches": _batches(), "mesh": MeshConfig(**{"dp": 1, **mesh}),
            "kw": PP_KW if mesh.get("pp", 1) > 1 else {}}


@pytest.fixture(scope="module")
def runs():
    """{label: each rank's (losses, params, masks, redraws, differs, coords,
    stage)}, and "one": the one-rank run's."""
    payloads = {w: {"kw": KW, "mesh": MeshConfig(dp=w),
                    "runs": [_run(mesh) for _, mesh, world, _ in MESHES if world == w]}
                for w in (2, 4)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        got = {w: pool.submit(workers.run_ranks, w, combo.dropout_runs, payloads[w], 240)
               for w in payloads}
        one = combo.trainer_run(None, _run({}), KW)
        got = {w: f.result() for w, f in got.items()}
    out, seen = {"one": [one]}, {2: 0, 4: 0}
    for label, _, world, _ in MESHES:
        out[label] = [ranks[seen[world]] for ranks in got[world]]
        seen[world] += 1
    return out


def _slice(full, row, token, mask):
    b, t, _ = mask.shape
    return full[row:row + b, token:token + t]


@pytest.mark.parametrize("label,twin", [(m[0], m[3]) for m in MESHES if m[3] is not None])
def test_masks_are_the_twin_masks_slices(runs, label, twin):
    (_, _, ref_masks, _, _), = [r[:5] for r in runs[twin][:1]]
    if twin != "one":  # the pp twin: every stage's keys, each stage its own blocks
        ref_masks = {}
        for r in runs[twin]:
            ref_masks.update(r[2])
    n = 0
    for r, res in enumerate(runs[label]):
        masks = res[2]
        assert masks, f"rank {r} drew no mask"
        for key, draws in masks.items():
            assert key in ref_masks, f"rank {r}: key {key} not in the twin's"
            (_, _, full), = ref_masks[key]
            for row, token, mask in draws:
                np.testing.assert_array_equal(mask, _slice(full, row, token, mask),
                                              err_msg=f"rank {r} {key} at ({row}, {token})")
                n += 1
    # each rank draws every block's two masks a step (its stage's under pp)
    per_rank = 2 * MODEL.n_layers * KW["steps"] * (PP_KW["pp_microbatches"]
                                                   if "pp" in label else 1)
    per_rank //= 2 if "pp" in label else 1
    assert n == per_rank * len(runs[label])


@pytest.mark.parametrize("label,twin", [(m[0], m[3]) for m in MESHES if m[3] is not None])
def test_params_match_the_twin(runs, label, twin):
    want_losses, want_params = runs[twin][0][:2]
    for r, (losses, params, *_) in enumerate(runs[label]):
        np.testing.assert_allclose(losses, want_losses, rtol=2e-5, atol=2e-5, err_msg=f"rank {r}")
        for n, p in params.items():
            np.testing.assert_allclose(p, want_params[n], rtol=3e-5, atol=3e-5,
                                       err_msg=f"rank {r} {n}")


@pytest.mark.parametrize("label", ["one"] + [m[0] for m in MESHES])
def test_every_recomputation_redraws_its_masks(runs, label):
    for r, res in enumerate(runs[label]):
        redraws, differs = res[3], res[4]
        assert redraws > 0 and differs == 0, (label, r, redraws, differs)


@functools.lru_cache(maxsize=None)
def _keep(seed, site, shape, row=0, token=0, rate=0.1):
    from orion_tpu_torch.models.transformer import DropoutKey, dropout_keep

    return dropout_keep(DropoutKey(seed, row, token), site, shape, rate)


def test_dropout_keep_reproduces_and_depends_on_every_key_word():
    shape = (4, 32, 64)
    a = _keep(123, 0, shape)
    assert torch.equal(a, _keep(123, 0, shape))
    for other in (_keep(124, 0, shape), _keep(123, 1, shape), _keep(123, 0, shape, row=1),
                  _keep(123, 0, shape, token=1)):
        assert not torch.equal(a, other)
    # a slice of rows and tokens is the same slice of the whole mask
    assert torch.equal(_keep(123, 0, (2, 8, 64), row=1, token=5), a[1:3, 5:13])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_and_scaling(rate):
    from orion_tpu_torch.models.transformer import DropoutKey, _dropout

    shape = (16, 128, 256)
    keep = _keep(7, 1, shape, rate=rate)
    n, p = keep.numel(), 1.0 - rate
    assert abs(int(keep.sum()) - n * p) < 6 * (n * p * (1 - p)) ** 0.5
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    y = _dropout(x, rate, DropoutKey(7), 1)
    assert torch.equal(y, torch.where(keep, x / p, torch.zeros(())))


@pytest.mark.parametrize("n", [1, 7, 128, 513])
def test_counter_below_is_the_int64_hash_below_the_bound(n):
    from orion_tpu_torch.utils import rng as rngs

    keys = torch.randint(0, 2**32, (16, 9, 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(n))
    keys[0, :3] = torch.tensor([[0, 0], [2**32 - 1, 2**32 - 1], [2**31, 2**31 - 1]])
    bits = rngs.counter_bits(keys, n)
    for bound in (0, 1, 2**31 - 1, 2**31, 2**31 + 1, round(0.9 * 2**32), 2**32 - 1):
        assert torch.equal(rngs.counter_below(keys, n, bound), bits < bound), bound
