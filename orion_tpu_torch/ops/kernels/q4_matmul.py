"""Int4 dequant-matmul: the CUDA kernel's wrapper and its plain PyTorch
version.

The port's counterpart of ``orion_tpu/quant.py::q4_matmul`` (the TPU kernel
``_q4_matmul_kernel``): ``y = x @ unpack(p) * s`` for x [B, d] (bf16 or
fp32, B <= ``MAX_ROWS``), p [d/2, out] int8 holding two int4 values a byte
along d (packed row k: input row 2k in the low nibble, 2k + 1 in the high
one, each sign-extended), s [out] fp32; fp32 products and sums, the scale
applied once, one rounding to x's dtype. ``quant.Int4Dense`` calls it for
decode's few rows.

``q4_matmul_cuda`` (``csrc/q4_matmul.cu``) launches the kernel or raises, and
counts its launches (``launches``: kernel launches and nothing else).
``q4_matmul_torch`` is the same function in plain PyTorch on any device.
The TPU kernel's ``block_out`` sizes its VMEM tiles and has no counterpart:
the CUDA kernel's strip of output channels is a constant of its source.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from orion_tpu_torch.ops.kernels.library import CSRC, check_launch, load, raise_if_grad
from orion_tpu_torch.ops.kernels.library import stream as _stream

Tensor = torch.Tensor

SOURCES = {"q4": CSRC / "q4_matmul.cu"}
MAX_ROWS = 64  # rows of x the kernel takes (decode); more take the split form

launches = 0  # kernel launches since import (or since a caller reset it)
_libs: dict = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"q4": {"q4_matmul": [_P] * 4 + [_I] * 5 + [_P]}}


def _library():
    if "q4" not in _libs:
        _libs["q4"] = load(SOURCES["q4"], _SIGNATURES["q4"])
    return _libs["q4"]


def _check(x: Tensor, p: Tensor, s: Tensor) -> None:
    """The TPU wrapper's shape checks: x [B, d] with d even, p [d/2, out],
    s [out]."""
    if x.dim() != 2 or p.dim() != 2:
        raise ValueError(f"q4_matmul takes x [B, d] and packed p [d/2, out]; got "
                         f"x{tuple(x.shape)}, p{tuple(p.shape)}")
    d, out = x.shape[1], p.shape[1]
    if d % 2:
        raise ValueError(f"q4_matmul needs an even contraction dim (x splits into even/odd "
                         f"nibble lanes); got d={d}")
    if p.shape[0] * 2 != d:
        raise ValueError(f"packed kernel rows {p.shape[0]} != d/2 = {d // 2}: the packed "
                         "buffer does not match this activation width")
    if tuple(s.shape) != (out,):
        raise ValueError(f"scale shape {tuple(s.shape)} != ({out},): one fp32 scale per "
                         "output channel")


def q4_matmul_cuda(x: Tensor, p: Tensor, s: Tensor) -> Tensor:
    """Launch the kernel on the current stream -> y [B, out] in x's dtype.
    Raises on anything it does not take: the shape checks of ``_check``,
    more than ``MAX_ROWS`` rows, an input that requires grad while grad is
    enabled, CPU tensors, mixed devices, x not bf16 / fp32, p not int8, s not
    fp32, non-contiguous inputs."""
    global launches
    raise_if_grad([x], "a full-precision model (a quantized one serves only)")
    _check(x, p, s)
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"q4_matmul_cuda takes at most {MAX_ROWS} rows; got {x.shape[0]}")
    check_launch("q4_matmul_cuda", [x], [s])
    if p.dtype != torch.int8 or p.device != x.device or not p.is_contiguous():
        raise TypeError("p must be a contiguous int8 tensor on x's device")
    b, d = x.shape
    out = p.shape[1]
    y = torch.empty(b, out, dtype=x.dtype, device=x.device)
    if b == 0:
        return y
    vec = int(out % 4 == 0 and p.data_ptr() % 4 == 0)  # whole 4-byte words of p
    with torch.cuda.device(x.device):
        err = _library().q4_matmul(
            x.data_ptr(), p.data_ptr(), s.data_ptr(), y.data_ptr(), b, d, out,
            int(x.dtype == torch.bfloat16), vec, _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"q4_matmul kernel failed: cudaError_t {err}")
    launches += 1
    return y


def unpack_nibbles(p: Tensor) -> Tuple[Tensor, Tensor]:
    """[in/2, out] packed int8 -> (low, high) nibbles as int32 in [-8, 7],
    sign-extended by arithmetic shifts in 32 bits (an 8-bit shift in place
    could wrap)."""
    p32 = p.int()
    return (p32 << 28) >> 28, p32 >> 4


def q4_matmul_torch(x: Tensor, p: Tensor, s: Tensor) -> Tensor:
    """The kernel's function in plain PyTorch, on any device: the nibbles
    unpacked in 32 bits, fp32 products and sums, times s, rounded once to x's
    dtype."""
    _check(x, p, s)
    lo, hi = unpack_nibbles(p)
    xf = x.float()
    y = xf[:, 0::2] @ lo.float() + xf[:, 1::2] @ hi.float()
    return (y * s).to(x.dtype)


__all__ = ["q4_matmul_cuda", "q4_matmul_torch", "unpack_nibbles", "SOURCES", "MAX_ROWS"]
