"""Which kernel of the grouped matmul (rows 9, 10) the wrappers launch.

``gmm_variant`` / ``gmm_dw_variant`` choose from dtype, widths and alignment
alone, before any launch: "wgmma" (TMA tensor maps into ``wgmma``) for bf16
operands whose widths are multiples of 8 and whose bases are 16-byte
aligned, "simt" for everything else. Pure functions of the tensors'
metadata, so they run here on CPU tensors; the launches themselves are held
on the card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from orion_tpu_torch.ops.kernels import gmm as gm

BF16, FP32 = torch.bfloat16, torch.float32


def _t(*shape, dtype=BF16):
    return torch.zeros(*shape, dtype=dtype)


@pytest.mark.parametrize(
    "x,w,transpose_w,want",
    [
        (_t(8704, 2048), _t(4, 2048, 5504), False, "wgmma"),  # moe_1b3_4e's gate / up
        (_t(8704, 5504), _t(4, 5504, 2048), False, "wgmma"),  # its down product
        (_t(8704, 5504), _t(4, 2048, 5504), True, "wgmma"),  # dx against w^T
        (_t(512, 200), _t(4, 200, 328), False, "wgmma"),  # K, N past the tiles, multiples of 8
        (_t(512, 100), _t(4, 100, 200), False, "simt"),  # K 100
        (_t(512, 96), _t(4, 96, 204), False, "simt"),  # N 204
        (_t(512, 200), _t(4, 100, 200), True, "simt"),  # dx: w [E, N 100, K 200]
        (_t(256, 128, dtype=FP32), _t(4, 128, 384, dtype=FP32), False, "simt"),  # tiny widths
        (_t(256, 128, dtype=FP32), _t(4, 384, 128, dtype=FP32), True, "simt"),
    ],
)
def test_forward_variant(x, w, transpose_w, want):
    assert gm.gmm_variant(x, w, transpose_w) == want


@pytest.mark.parametrize(
    "x,g,want",
    [
        (_t(8704, 2048), _t(8704, 5504), "wgmma"),  # gate / up's dw
        (_t(8704, 5504), _t(8704, 2048), "wgmma"),  # down's dw
        (_t(512, 200), _t(512, 328), "wgmma"),
        (_t(512, 100), _t(512, 200), "simt"),  # D 100
        (_t(512, 96), _t(512, 204), "simt"),  # H 204
        (_t(256, 128, dtype=FP32), _t(256, 384, dtype=FP32), "simt"),
    ],
)
def test_dw_variant(x, g, want):
    assert gm.gmm_dw_variant(x, g) == want


def test_a_misaligned_base_takes_simt():
    """A view one element into its storage (2 bytes) cannot be a TMA base."""
    flat = _t(8 + 256 * 64)
    x = flat[1:1 + 256 * 64].view(256, 64)
    w = _t(2, 64, 128)
    assert (x.data_ptr() - flat.data_ptr()) % 16 == 2 and flat.data_ptr() % 16 == 0
    assert gm.gmm_variant(x, w) == "simt"
    assert gm.gmm_variant(flat[8:].view(256, 64), w) == "wgmma"  # 16 bytes in
    assert gm.gmm_dw_variant(x, _t(256, 128)) == "simt"
