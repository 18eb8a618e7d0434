"""In-place decode caches: ``Attention.decode_step`` writes a softmax cache
and a swa ring in place (their ``data_ptr`` is the state's own), a row
masked out of ``write`` keeps its cache, its ring and its (S, z) bitwise,
and the in-place walk gives the tokens and logits of the out-of-place one
(each step on a fresh copy of the state, as the caches were before)."""

import numpy as np
import pytest
import torch

from orion_tpu_torch import generate as gen
from orion_tpu_torch.models.transformer import init_decode_state, snapshot_decode_state
from torch_serving_common import CFG, GREEDY, SAMPLED, prompt, states_equal, torch_model

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    return torch_model()


def _prefilled(model, b=3, length=7):
    tokens = torch.from_numpy(np.concatenate([prompt(70 + i, length) for i in range(b)]))
    with torch.inference_mode():
        return model.prefill_last(tokens)


@pytest.mark.parametrize("per_seq", [False, True], ids=["scalar_t", "per_row_t"])
def test_caches_are_written_in_place(model, per_seq):
    _, states = _prefilled(model)
    ptrs = [{k: v.data_ptr() for k, v in st.items()} for st in states]
    t = torch.tensor([7, 7, 7]) if per_seq else 7
    with torch.inference_mode():
        _, new = model.decode_step(torch.tensor([1, 2, 3]), states, t)
    for lt, p, st, nst in zip(CFG.layer_types, ptrs, states, new):
        if lt == "linear":  # (S, z) stays a new pair of tensors each step
            assert nst["s"].data_ptr() != p["s"]
            continue
        assert all(nst[k] is st[k] and st[k].data_ptr() == p[k] for k in ("k", "v")), lt
    slot = {"softmax": 7, "swa": 7 % CFG.window}
    for lt, st in zip(CFG.layer_types, new):
        if lt != "linear":
            assert bool(st["k"][:, :, slot[lt]].abs().sum(-1).gt(0).all()), lt


def test_a_masked_row_keeps_its_state_bitwise(model):
    """Rows 0 and 2 write, row 1 does not: row 1's cache, ring and (S, z)
    are bitwise what they were, at a position past the ring's wrap too."""
    _, states = _prefilled(model, length=9)
    before = snapshot_decode_state(states)
    write = torch.tensor([True, False, True])
    with torch.inference_mode():
        for step in range(6):
            _, states = model.decode_step(torch.tensor([4, 5, 6]), states,
                                          torch.tensor([9 + step, 9 + step, 9 + step]), write)
    for lt, st, old in zip(CFG.layer_types, states, before):
        for k in st:
            assert torch.equal(st[k][1], old[k][1]), (lt, k)
            assert not torch.equal(st[k][0], old[k][0]), (lt, k)


@pytest.mark.parametrize("sample", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_in_place_walk_equals_the_out_of_place_walk(model, sample):
    p = torch.from_numpy(np.concatenate([prompt(80, 11), prompt(81, 11)]))
    keys = gen.request_keys(4, 2)
    walks = []
    for copy in (False, True):
        tok, states, t, _ = gen.prefill_carry(model, p, sample, keys)
        toks, logits = [], []
        with torch.inference_mode():
            for i in range(14):  # past the ring's wrap (window 4)
                lg, states = model.decode_step(
                    tok, snapshot_decode_state(states) if copy else states, t + i)
                tok = gen.sample_rows(lg, gen.rngs.fold_keys(keys, i + 1), sample)
                toks.append(tok)
                logits.append(lg)
        walks.append((torch.stack(toks), torch.stack(logits), states))
    (ta, la, sa), (tb, lb, sb) = walks
    assert torch.equal(ta, tb) and torch.equal(la, lb) and states_equal(sa, sb)


def test_init_decode_state_then_decode_in_place(model):
    """A zero state from ``init_decode_state`` (made outside inference mode)
    takes the in-place writes too."""
    states = init_decode_state(CFG, 2, "cpu")
    ring = states[2]["k"]
    with torch.no_grad():
        _, new = model.decode_step(torch.tensor([1, 2]), states, 0)
    assert new[2]["k"] is ring and bool(ring[:, :, 0].abs().sum() > 0)
