"""``generate`` on the 4-rank meshes the JAX CLI takes -- sp 4 on a prompt
it does not divide (6 tokens, right-padded to 8), dp 2 x tp 2, sp 2 x tp 2,
and dp 4 (sampled) -- held against the JAX package on gloo CPU ranks (one
spawn shared by the cases; the model, the references and the checks:
``tests/torch_genmesh_common.py``). The 2-rank meshes:
``tests/test_torch_genmesh.py``."""

import pytest

import torch_genmesh_common as common

MESHES = {"sp4 (padded)": dict(sp=4), "dp2 x tp2": dict(dp=2, tp=2),
          "sp2 x tp2": dict(sp=2, tp=2)}
SAMPLED = {"dp4": dict(dp=4)}


@pytest.fixture(scope="module")
def runs():
    """{label: (each rank's result, the JAX tokens at its mesh or None)}."""
    cases = [common.case(sizes) for sizes in MESHES.values()]
    cases += [common.case(sizes, sample=common.SAMPLE, seed=common.SEED)
              for sizes in SAMPLED.values()]

    def jax_work():
        common.jax_prefill()
        return [common.jax_meshed(sizes) for sizes in MESHES.values()] + [None] * len(SAMPLED)

    ranks, meshed = common.run_with_jax(4, cases, jax_work)
    return dict(zip([*MESHES, *SAMPLED], zip(ranks, meshed)))


@pytest.mark.parametrize("label", list(MESHES))
def test_greedy_tokens_match_jax_on_the_mesh(runs, label):
    common.check_greedy(*runs[label])


@pytest.mark.parametrize("label", list(MESHES))
def test_prefill_logits_and_states_match_jax(runs, label):
    common.check_prefill(runs[label][0], MESHES[label])


@pytest.mark.parametrize("label", list(SAMPLED))
def test_sampled_tokens_on_a_data_mesh_equal_the_one_rank_run(runs, label):
    common.check_sampled(runs[label][0])
    common.check_prefill(runs[label][0], SAMPLED[label])
