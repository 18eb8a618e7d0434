"""``generate`` on the 2-rank meshes the JAX CLI takes -- sp 2, dp 2 and
fsdp 2 -- held against the JAX package on gloo CPU ranks (one spawn shared
by the cases; the model, the references and the checks:
``tests/torch_genmesh_common.py``). The 4-rank meshes:
``tests/test_torch_genmesh4.py``; the quantized models:
``tests/test_torch_genmesh_quant.py``; the CLI and what still refuses:
``tests/test_torch_genmesh_cli.py``."""

import pytest

import torch_genmesh_common as common

MESHES = {"sp2": dict(sp=2), "dp2": dict(dp=2), "fsdp2": dict(fsdp=2)}
SAMPLED = ("dp2",)


@pytest.fixture(scope="module")
def runs():
    """{label: (each rank's result, the JAX tokens at its mesh)}."""
    cases = [common.case(sizes, **(dict(sample=common.SAMPLE, seed=common.SEED)
                                   if label in SAMPLED else {}))
             for label, sizes in MESHES.items()]

    def jax_work():
        common.jax_prefill()
        return [common.jax_meshed(sizes) for sizes in MESHES.values()]

    ranks, meshed = common.run_with_jax(2, cases, jax_work)
    return dict(zip(MESHES, zip(ranks, meshed)))


@pytest.mark.parametrize("label", list(MESHES))
def test_greedy_tokens_match_jax_on_the_mesh(runs, label):
    common.check_greedy(*runs[label])


@pytest.mark.parametrize("label", list(MESHES))
def test_prefill_logits_and_states_match_jax(runs, label):
    common.check_prefill(runs[label][0], MESHES[label])


@pytest.mark.parametrize("label", SAMPLED)
def test_sampled_tokens_on_a_data_mesh_equal_the_one_rank_run(runs, label):
    common.check_sampled(runs[label][0])
