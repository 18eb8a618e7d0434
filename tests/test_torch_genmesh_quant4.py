"""Quantized ``generate`` (int8, int4) on a 4-rank mesh -- dp 2 x fsdp 2 --
held against the JAX package's quantized ``generate`` on the same mesh, on
gloo CPU ranks (one spawn shared by the cases; ``tests/torch_genmesh_common.py``).

- greedy tokens of the port's ``quantize_for_decode`` on the mesh equal the
  JAX ``generate(..., mesh=..., quant=...)``'s, which equal the JAX
  single-device quantized run's;
- each rank's quantized buffers are bitwise the one-rank quantization cut
  to its shards (quantize whole, then cut: the JAX order);
- the JAX package's own quantized tree, cut straight onto the port's int8
  model at dp 2 x fsdp 2 (``shard_state`` of a quantized state dict), emits
  the same tokens.

The 2-rank meshes tp 2 and sp 2: ``tests/test_torch_genmesh_quant.py``; MoE
layers on a 4-rank mesh: ``tests/test_torch_genmesh_moe.py``.
"""

import numpy as np
import pytest

import torch_genmesh_common as common

CASES = {"dp2 x fsdp2 int8": (dict(dp=2, fsdp=2), "int8"),
         "dp2 x fsdp2 int4": (dict(dp=2, fsdp=2), "int4")}
QTREE = ("dp2 x fsdp2 int8", dict(dp=2, fsdp=2), "int8")


@pytest.fixture(scope="module")
def runs():
    """{label: (each rank's result, the JAX tokens at its mesh)}."""
    cases = [common.case(sizes, quant=q, buffers=True) for sizes, q in CASES.values()]
    cases.append(common.case(QTREE[1], quant=QTREE[2], qtree=common.jax_quantized(QTREE[2])[0]))

    def jax_work():
        for q in ("int8", "int4"):
            common.jax_quantized(q)
        return [common.jax_meshed(sizes, q) for sizes, q in CASES.values()]

    ranks, meshed = common.run_with_jax(4, cases, jax_work)
    return dict(zip(CASES, zip(ranks, meshed))), ranks[len(CASES)]


@pytest.mark.parametrize("label", list(CASES))
def test_quantized_greedy_tokens_match_jax_on_the_mesh(runs, label):
    ranks, meshed = runs[0][label]
    np.testing.assert_array_equal(meshed, common.jax_quantized(CASES[label][1])[1])
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["greedy"], meshed, err_msg=f"rank {r}")


@pytest.mark.parametrize("label", list(CASES))
def test_quantized_shards_are_the_whole_quantization_cut(runs, label):
    sizes, quant = CASES[label]
    common.check_quantized_shards(runs[0][label][0], sizes, quant)


def test_the_jax_quantized_tree_loads_onto_the_mesh(runs):
    want = common.jax_quantized(QTREE[2])[1]
    for r, res in enumerate(runs[1]):
        np.testing.assert_array_equal(res["greedy"], want, err_msg=f"rank {r}")
