"""Which kernels of linear attention (rows 1-4) the wrappers launch.

``causal_dot_norm_variant`` (the forward) chooses from dtype, widths and
alignment alone, before any launch: "wgmma" (TMA tensor maps into
``wgmma``) for bf16 at Dk 128 with Dv a multiple of 64 and 16-byte-aligned
bases, "simt" for everything else; ``causal_dot_dq_den_variant`` and
``causal_dot_rev_variant`` (the backward's two passes) likewise, for bf16
at a contracted width of 128, the latter for the public op's raw reverse
pass (row 5) too; ``causal_dot_raw_variant`` (the public op's raw forward,
row 2) under row 1's conditions, as the op's forward and as its dq pass.
Pure functions of the tensors' metadata,
so they run here on CPU tensors; the launches themselves are held on the
card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from orion_tpu_torch.ops.kernels import causal_dot as cd

BF16, FP32 = torch.bfloat16, torch.float32


def _qkv(bh, t, dk, dv, dtype=BF16):
    return (torch.empty(bh, t, dk, dtype=dtype), torch.empty(bh, t, dk, dtype=dtype),
            torch.empty(bh, t, dv, dtype=dtype))


@pytest.mark.parametrize(
    "bh,t,dk,dv,dtype,want",
    [
        (128, 1024, 128, 128, BF16, "wgmma"),  # lm_1b3's training step, B 8 x H 16
        (64, 1024, 128, 128, BF16, "wgmma"),  # its generate shape
        (4, 1, 128, 64, BF16, "wgmma"),  # T 1, one value tile
        (4, 1000, 128, 192, BF16, "wgmma"),  # three value tiles
        (4, 100, 128, 96, BF16, "simt"),  # Dv not a multiple of 64
        (4, 100, 64, 128, BF16, "simt"),  # Dk 64
        (4, 100, 128, 128, FP32, "simt"),  # fp32 at Dk 128
        (8, 300, 32, 32, FP32, "simt"),  # the tiny models
    ],
)
def test_norm_variant(bh, t, dk, dv, dtype, want):
    assert cd.causal_dot_norm_variant(*_qkv(bh, t, dk, dv, dtype)) == want


def test_a_misaligned_base_takes_simt():
    """A view one element into its storage (2 bytes) cannot be a TMA base;
    each of the three operands alone decides."""
    flat = torch.empty(8 + 4 * 64 * 128, dtype=BF16)
    odd = flat[1:1 + 4 * 64 * 128].view(4, 64, 128)
    even = flat[8:8 + 4 * 64 * 128].view(4, 64, 128)  # 16 bytes in
    assert (odd.data_ptr() - flat.data_ptr()) % 16 == 2 and flat.data_ptr() % 16 == 0
    q, k, v = _qkv(4, 64, 128, 128)
    assert cd.causal_dot_norm_variant(even, k, v) == "wgmma"
    for i in range(3):
        ops = [q, k, v]
        ops[i] = odd
        assert cd.causal_dot_norm_variant(*ops) == "simt", i


@pytest.mark.parametrize("i", [0, 1, 2])
def test_one_operand_in_fp32_takes_simt(i):
    ops = list(_qkv(2, 64, 128, 128))
    ops[i] = ops[i].float()
    assert cd.causal_dot_norm_variant(*ops) == "simt"


# The backward passes (rows 3 and 4): ``causal_dot_dq_den_variant(g, v, k)``
# takes wgmma for bf16 at Dv 128 (its contracted width) with Dk a multiple of
# 64, ``causal_dot_rev_variant(q, k, v, g)`` for bf16 at Dk = Dv = 128;
# both want 16-byte-aligned bases.


def _bwd(bh, t, dk, dv, dtype=BF16):
    """(q, k, v, g) of a layer's backward: q, k [BH, T, Dk], v, g [BH, T, Dv]."""
    return (torch.empty(bh, t, dk, dtype=dtype), torch.empty(bh, t, dk, dtype=dtype),
            torch.empty(bh, t, dv, dtype=dtype), torch.empty(bh, t, dv, dtype=dtype))


@pytest.mark.parametrize(
    "bh,t,dk,dv,dtype,want_dq,want_rev",
    [
        (128, 1024, 128, 128, BF16, "wgmma", "wgmma"),  # lm_1b3's training step
        (4, 1, 128, 128, BF16, "wgmma", "wgmma"),  # T 1
        (4, 1000, 64, 128, BF16, "wgmma", "simt"),  # dq: one output tile of Dk 64
        (4, 1000, 192, 128, BF16, "wgmma", "simt"),  # dq: three output tiles
        (32, 1000, 128, 96, BF16, "simt", "simt"),  # Dk 128 Dv 96 (chip_smoke's simt case)
        (4, 100, 100, 128, BF16, "simt", "simt"),  # Dk not a multiple of 64
        (4, 100, 128, 128, FP32, "simt", "simt"),  # fp32 at D 128
        (8, 300, 32, 32, FP32, "simt", "simt"),  # the tiny models
    ],
)
def test_bwd_variants(bh, t, dk, dv, dtype, want_dq, want_rev):
    q, k, v, g = _bwd(bh, t, dk, dv, dtype)
    assert cd.causal_dot_dq_den_variant(g, v, k) == want_dq
    assert cd.causal_dot_rev_variant(q, k, v, g) == want_rev


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_bwd_misaligned_base_takes_simt(i):
    """A view one element into its storage (2 bytes) cannot be a TMA base:
    each operand of the reverse pass alone decides, and g, v or k of the dq
    pass."""
    flat = torch.empty(8 + 4 * 64 * 128, dtype=BF16)
    odd = flat[1:1 + 4 * 64 * 128].view(4, 64, 128)
    ops = list(_bwd(4, 64, 128, 128))
    assert cd.causal_dot_rev_variant(*ops) == "wgmma"
    ops[i] = odd
    q, k, v, g = ops
    assert cd.causal_dot_rev_variant(q, k, v, g) == "simt"
    assert cd.causal_dot_dq_den_variant(g, v, k) == ("wgmma" if i == 0 else "simt")


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_bwd_one_operand_in_fp32_takes_simt(i):
    ops = list(_bwd(2, 64, 128, 128))
    ops[i] = ops[i].float()
    q, k, v, g = ops
    assert cd.causal_dot_rev_variant(q, k, v, g) == "simt"
    assert cd.causal_dot_dq_den_variant(g, v, k) == ("wgmma" if i == 0 else "simt")


# The public op's raw forward (row 2): ``causal_dot_raw_variant(q, k, v)``
# takes wgmma under row 1's conditions. The op runs it twice: as its forward
# on (q, k, v) and as its dq pass on (g, v, k), whose contracted width is Dv.


@pytest.mark.parametrize(
    "bh,t,dk,dv,dtype,want_fwd,want_dq",
    [
        (128, 1024, 128, 128, BF16, "wgmma", "wgmma"),  # the op at lm_1b3's per-layer shape
        (4, 1, 128, 128, BF16, "wgmma", "wgmma"),  # T 1
        (128, 1024, 128, 64, BF16, "wgmma", "simt"),  # Dv 64: the dq pass contracts over 64
        (4, 1000, 128, 192, BF16, "wgmma", "simt"),  # three value tiles; the dq pass over 192
        (4, 1000, 64, 128, BF16, "simt", "wgmma"),  # Dk 64: the dq pass's one output tile
        (4, 100, 128, 96, BF16, "simt", "simt"),  # Dv not a multiple of 64
        (4, 100, 128, 128, FP32, "simt", "simt"),  # fp32 at D 128
        (8, 300, 32, 32, FP32, "simt", "simt"),  # chip_smoke's fp32 cases
    ],
)
def test_raw_variant(bh, t, dk, dv, dtype, want_fwd, want_dq):
    q, k, v = _qkv(bh, t, dk, dv, dtype)
    g = torch.empty(bh, t, dv, dtype=dtype)
    assert cd.causal_dot_raw_variant(q, k, v) == want_fwd
    assert cd.causal_dot_raw_variant(g, v, k) == want_dq


@pytest.mark.parametrize("i", [0, 1, 2])
def test_raw_misaligned_or_fp32_operand_takes_simt(i):
    """Each of the three operands alone decides: a base 2 bytes off 16, or
    one operand in fp32."""
    flat = torch.empty(8 + 4 * 64 * 128, dtype=BF16)
    odd = flat[1:1 + 4 * 64 * 128].view(4, 64, 128)
    ops = list(_qkv(4, 64, 128, 128))
    assert cd.causal_dot_raw_variant(*ops) == "wgmma"
    ops[i] = odd
    assert cd.causal_dot_raw_variant(*ops) == "simt"
    ops = list(_qkv(4, 64, 128, 128))
    ops[i] = ops[i].float()
    assert cd.causal_dot_raw_variant(*ops) == "simt"


# The public op's raw reverse pass (row 5) takes the same rule as row 4,
# ``causal_dot_rev_variant(q, k, v, g)``: all four bf16 at Dk = Dv = 128 with
# 16-byte-aligned bases (one operand in fp32: ``test_bwd_one_operand_in_fp32_takes_simt``).


@pytest.mark.parametrize(
    "bh,t,dk,dv,dtype,want",
    [
        (128, 1024, 128, 128, BF16, "wgmma"),  # the op at lm_1b3's per-layer shape
        (128, 1000, 128, 128, BF16, "wgmma"),  # a ragged T
        (4, 1, 128, 128, BF16, "wgmma"),  # T 1
        (128, 1024, 128, 64, BF16, "simt"),  # Dv 64: the dk role contracts over 64
        (4, 1000, 64, 128, BF16, "simt"),  # Dk 64: the dv role contracts over 64
        (4, 100, 128, 96, BF16, "simt"),  # Dv not a multiple of 64
        (4, 100, 128, 128, FP32, "simt"),  # fp32 at D 128
        (8, 200, 32, 32, FP32, "simt"),  # chip_smoke's fp32 cases
    ],
)
def test_rev_variant(bh, t, dk, dv, dtype, want):
    q, k, v, g = _bwd(bh, t, dk, dv, dtype)
    assert cd.causal_dot_rev_variant(q, k, v, g) == want


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_rev_one_misaligned_base_takes_simt(i):
    """A view one element into its storage (2 bytes) cannot be a TMA base:
    each of q, k, v, g alone decides."""
    flat = torch.empty(8 + 4 * 64 * 128, dtype=BF16)
    odd = flat[1:1 + 4 * 64 * 128].view(4, 64, 128)
    even = flat[8:8 + 4 * 64 * 128].view(4, 64, 128)  # 16 bytes in
    ops = list(_bwd(4, 64, 128, 128))
    ops[i] = even
    assert cd.causal_dot_rev_variant(*ops) == "wgmma"
    ops[i] = odd
    assert cd.causal_dot_rev_variant(*ops) == "simt"
