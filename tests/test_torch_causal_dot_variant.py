"""Which kernel of the linear-attention forward (row 1) the wrapper launches.

``causal_dot_norm_variant`` chooses from dtype, widths and alignment alone,
before any launch: "wgmma" (TMA tensor maps into ``wgmma``) for bf16 at Dk
128 with Dv a multiple of 64 and 16-byte-aligned bases, "simt" for
everything else. A pure function of the tensors' metadata, so it runs here
on CPU tensors; the launches themselves are held on the card
(``tests/test_torch_cuda.py``).
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
