"""Which kernels of flash attention (rows 6, 7, 8) the wrappers launch.

``flash_fwd_variant`` (the forward) and ``flash_bwd_variant`` (the backward)
choose from dtype, head width and alignment alone, before any launch:
"wgmma" (TMA tensor maps into ``wgmma``) for bf16 at D 128 with
16-byte-aligned bases, "simt" for everything else. Pure functions of the
tensors' metadata, so they run here on CPU tensors; the launches themselves
are held on the card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from orion_tpu_torch.ops.kernels import flash_attention as fa

BF16, FP32 = torch.bfloat16, torch.float32


def _qkvg(bh, t_q, t_k, d, dtype=BF16):
    return (torch.empty(bh, t_q, d, dtype=dtype), torch.empty(bh, t_k, d, dtype=dtype),
            torch.empty(bh, t_k, d, dtype=dtype), torch.empty(bh, t_q, d, dtype=dtype))


@pytest.mark.parametrize(
    "bh,t_q,t_k,d,dtype,want",
    [
        (128, 2048, 2048, 128, BF16, "wgmma"),  # hybrid_1b3's training step, B 8 x H 16
        (64, 1536, 1536, 128, BF16, "wgmma"),  # its generate shape
        (4, 1000, 1500, 128, BF16, "wgmma"),  # more keys than queries
        (3, 1, 1, 128, BF16, "wgmma"),  # T 1
        (8, 300, 300, 32, BF16, "simt"),  # the tiny widths
        (8, 300, 300, 64, BF16, "simt"),  # the LRA widths
        (8, 300, 300, 96, BF16, "simt"),
        (8, 300, 300, 128, FP32, "simt"),  # fp32 at D 128
        (8, 300, 300, 32, FP32, "simt"),  # the tiny models' training
    ],
)
def test_backward_variant(bh, t_q, t_k, d, dtype, want):
    assert fa.flash_bwd_variant(*_qkvg(bh, t_q, t_k, d, dtype)) == want


def test_a_misaligned_base_takes_simt():
    """A view one element into its storage (2 bytes) cannot be a TMA base;
    each of the four operands alone decides."""
    flat = torch.empty(8 + 4 * 64 * 128, dtype=BF16)
    odd = flat[1:1 + 4 * 64 * 128].view(4, 64, 128)
    even = flat[8:8 + 4 * 64 * 128].view(4, 64, 128)  # 16 bytes in
    assert (odd.data_ptr() - flat.data_ptr()) % 16 == 2 and flat.data_ptr() % 16 == 0
    q, k, v, g = _qkvg(4, 64, 64, 128)
    assert fa.flash_bwd_variant(q, k, v, g) == "wgmma"
    assert fa.flash_bwd_variant(even, k, v, g) == "wgmma"
    for i in range(4):
        ops = [q, k, v, g]
        ops[i] = odd
        assert fa.flash_bwd_variant(*ops) == "simt", i


def test_one_operand_in_fp32_takes_simt():
    q, k, v, g = _qkvg(2, 64, 64, 128)
    assert fa.flash_bwd_variant(q, k, v, g.float()) == "simt"


@pytest.mark.parametrize(
    "bh,t_q,t_k,d,dtype,want",
    [
        (128, 2048, 2048, 128, BF16, "wgmma"),  # hybrid_1b3's training step
        (64, 1536, 1536, 128, BF16, "wgmma"),  # its generate shape
        (4, 1000, 1500, 128, BF16, "wgmma"),  # more keys than queries
        (3, 1, 1, 128, BF16, "wgmma"),  # T 1
        (8, 300, 300, 64, BF16, "simt"),  # the LRA widths
        (8, 300, 300, 128, FP32, "simt"),  # fp32 at D 128
        (8, 300, 300, 32, FP32, "simt"),  # the tiny models
    ],
)
def test_forward_variant(bh, t_q, t_k, d, dtype, want):
    assert fa.flash_fwd_variant(*_qkvg(bh, t_q, t_k, d, dtype)[:3]) == want


def test_forward_a_misaligned_base_or_one_fp32_operand_takes_simt():
    flat = torch.empty(8 + 4 * 64 * 128, dtype=BF16)
    odd = flat[1:1 + 4 * 64 * 128].view(4, 64, 128)
    q, k, v, _ = _qkvg(4, 64, 64, 128)
    assert fa.flash_fwd_variant(q, k, v) == "wgmma"
    for i in range(3):
        ops = [q, k, v]
        ops[i] = odd
        assert fa.flash_fwd_variant(*ops) == "simt", i
        ops[i] = [q, k, v][i].float()
        assert fa.flash_fwd_variant(*ops) == "simt", i
