"""Int4 dequant-matmul: the CUDA kernels' wrapper and their plain PyTorch
version.

The port's counterpart of ``orion_tpu/quant.py::q4_matmul`` (the TPU kernel
``_q4_matmul_kernel``): ``y = x @ unpack(p) * s`` for x [B, d] (bf16 or
fp32, B <= ``MAX_ROWS``), p [d/2, out] int8 holding two int4 values a byte
along d (packed row k: input row 2k in the low nibble, 2k + 1 in the high
one, each sign-extended), s [out] fp32; fp32 products and sums, the scale
applied once, one rounding to x's dtype. ``quant.Int4Dense`` calls it for
decode's few rows.

``q4_matmul_cuda`` (``csrc/q4_matmul.cu``) launches one of two kernels or
raises, and counts its launches (``launches``: kernel launches and nothing
else; ``launches_mma`` and ``launches_simt`` split it by variant). The
variant is chosen before the launch from dtype, widths and alignment alone
(``q4_matmul_variant``): "mma" (a cluster of blocks a strip of 64 output
channels splitting the packed rows, TMA into an mbarrier ring, the nibbles
turned into bf16 by bit operations, ``mma.sync`` on the tensor cores, the
partial sums added across the cluster in rank order) for bf16 x with d a
multiple of 8, out a multiple of 16 and 16-byte-aligned bases, every bf16
model's decode shape; "simt" (fp32 FMAs on the CUDA cores) for the rest. A
variant that fails to build or launch raises: it never gives way to the
other or to the plain version. ``q4_matmul_torch`` is the same function in
plain PyTorch on any device. The TPU kernel's ``block_out`` sizes its VMEM
tiles and has no counterpart: the kernels' strips are constants of the
source.

The host path is part of a decode step's cost (168 calls a step for
lm_1b3), so a call pays little beyond the launch: a weight (p, s) is
checked once, with its mma tensor map encoded once, and the result is kept
in ``_weights`` under p's identity, trusted while p and s are the same
tensor objects with the same version counters and data pointers (an
in-place reload such as ``load_state_dict``'s ``copy_`` bumps the version:
the next call checks again); x is checked at each call by a few attribute
reads; the stream is PyTorch's current one, read as a raw pointer; the
device is made current only when it is not. Anything the fast checks do not
accept goes through the full checks, which raise as they always did.

A call on a weight that was kept launches the mma kernel early
(programmatic dependent launch): it streams its weights in while the
kernel ahead of it on the stream ends, and reads x and writes y only after
that kernel has completed. A weight that is new or has changed since its
last call (an in-place reload bumps its version) launches without the
early start, after everything ahead of it on the stream, so its bytes are
never read before the kernel that wrote them has ended.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional, Tuple

import torch

from orion_tpu_torch.ops.kernels.library import CSRC, check_launch, load, raise_if_grad

Tensor = torch.Tensor

SOURCES = {"q4": CSRC / "q4_matmul.cu"}
MAX_ROWS = 64  # rows of x the kernels take (decode); more take the split form
MMA_OUT_STEP, MMA_D_STEP = 16, 8  # the mma variant's out and d must be multiples of these

launches = 0  # kernel launches since import (or since a caller reset it)
launches_mma = launches_simt = 0  # the launches by variant
_libs: dict = {}
_weights: dict = {}  # id(p) -> _Weight: a checked weight and its plan
_GRAD_PATH = "a full-precision model (a quantized one serves only)"
_DTYPES = (torch.bfloat16, torch.float32)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"q4": {"q4_matmul": [_P] * 4 + [_I] * 5 + [_P],
                      "q4_matmul_mma": [_P] * 4 + [_I, _I, _P],
                      "q4_plan": [_P, _P, _I, _I], "q4_plan_bytes": [],
                      "q4_geometry": [_I] * 4 + [_P]}}


def _library():
    if "q4" not in _libs:
        _libs["q4"] = load(SOURCES["q4"], _SIGNATURES["q4"])
    return _libs["q4"]


def _current_device() -> int:
    return torch._C._cuda_getDevice()


def _raw_stream(index: int) -> int:
    """PyTorch's current stream of device ``index`` as the int a C function
    takes."""
    return torch._C._cuda_getCurrentRawStream(index)


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


def _mma_weight(p: Tensor) -> bool:
    """p's half of the mma variant's conditions: out a multiple of 16 (TMA's
    row stride) and a 16-byte-aligned base."""
    return p.shape[-1] % MMA_OUT_STEP == 0 and p.data_ptr() % 16 == 0


def _mma_input(x: Tensor) -> bool:
    """x's half: bf16, d a multiple of 8, a 16-byte-aligned base."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % MMA_D_STEP == 0
            and x.data_ptr() % 16 == 0)


def q4_matmul_variant(x: Tensor, p: Tensor, s: Tensor) -> str:
    """The kernel that takes x [B, d] against p [d/2, out]: "mma" when x is
    bf16 with d a multiple of 8, out a multiple of 16 (TMA's row stride),
    and x and p 16-byte aligned, else "simt". From dtype, shape and
    alignment alone, before any launch; ``q4_matmul_cuda`` decides by the
    same two halves."""
    return "mma" if _mma_weight(p) and _mma_input(x) else "simt"


class _Weight:
    """A weight (p, s) that passed every check, with what its calls reuse:
    its widths, device, and the mma variant's plan (tensor map) once made."""

    __slots__ = ("p", "s", "key", "d", "out", "dev", "mma_ok", "plan", "__weakref__")

    def __init__(self, p: Tensor, s: Tensor):
        self.p, self.s = weakref.ref(p), weakref.ref(s)
        self.key = (p._version, p.data_ptr(), s._version, s.data_ptr())
        self.d, self.out = 2 * p.shape[0], p.shape[1]
        self.dev = p.get_device()
        self.mma_ok = _mma_weight(p)
        self.plan: Optional[ctypes.Array] = None

    def holds(self, p: Tensor, s: Tensor) -> bool:
        return (self.p() is p and self.s() is s
                and self.key == (p._version, p.data_ptr(), s._version, s.data_ptr()))


def _checked(x: Tensor, p: Tensor, s: Tensor) -> _Weight:
    """Every check of a call, in their order; raises on the first failure.
    Returns p's entry of ``_weights``, made anew."""
    raise_if_grad([x], _GRAD_PATH)
    _check(x, p, s)
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"q4_matmul_cuda takes at most {MAX_ROWS} rows; got {x.shape[0]}")
    check_launch("q4_matmul_cuda", [x], [s])
    if p.dtype != torch.int8 or p.device != x.device or not p.is_contiguous():
        raise TypeError("p must be a contiguous int8 tensor on x's device")
    w = _Weight(p, s)
    key = id(p)
    # the entry goes with p; a later tensor at the same id is told apart by holds()
    w_ref = weakref.ref(w)
    weakref.finalize(p, lambda: _weights.pop(key, None) if _weights.get(key) is w_ref() else None)
    _weights[key] = w
    return w


def _plan(w: _Weight, p: Tensor) -> ctypes.Array:
    """The mma variant's plan of ``w`` (p's tensor map and shape), made once."""
    if w.plan is None:
        lib = _library()
        plan = ctypes.create_string_buffer(lib.q4_plan_bytes())
        err = lib.q4_plan(plan, p.data_ptr(), p.shape[0], p.shape[1])
        if err != 0:
            raise RuntimeError(f"q4_matmul (mma): its tensor map failed: cudaError_t {err}")
        w.plan = plan
    return w.plan


def q4_matmul_cuda(x: Tensor, p: Tensor, s: Tensor) -> Tensor:
    """Launch the kernel ``q4_matmul_variant`` names on the current stream ->
    y [B, out] in x's dtype. Raises on anything it does not take: the shape
    checks of ``_check``, more than ``MAX_ROWS`` rows, an input that requires
    grad while grad is enabled, CPU tensors, mixed devices, x not bf16 /
    fp32, p not int8, s not fp32, non-contiguous inputs."""
    global launches, launches_mma, launches_simt
    w = _weights.get(id(p))
    early = (w is not None and w.holds(p, s) and x.dim() == 2 and x.shape[1] == w.d
             and x.shape[0] <= MAX_ROWS and x.dtype in _DTYPES and x.is_contiguous()
             and x.get_device() == w.dev and not (x.requires_grad and torch.is_grad_enabled()))
    if not early:
        w = _checked(x, p, s)
    b = x.shape[0]
    y = torch.empty((b, w.out), dtype=x.dtype, device=x.device)
    if b == 0:
        return y
    mma = w.mma_ok and _mma_input(x)
    if _current_device() != w.dev:
        with torch.cuda.device(w.dev):
            err = _launch(mma, early, w, x, p, s, y)
    else:
        err = _launch(mma, early, w, x, p, s, y)
    if err != 0:
        raise RuntimeError(f"q4_matmul kernel ({'mma' if mma else 'simt'}) failed: "
                           f"cudaError_t {err}")
    launches += 1
    if mma:
        launches_mma += 1
    else:
        launches_simt += 1
    return y


def _launch(mma: bool, early: bool, w: _Weight, x: Tensor, p: Tensor, s: Tensor,
            y: Tensor) -> int:
    """Launch the mma or simt kernel; the mma one with ``early`` (a weight
    checked at an earlier call and unchanged since) may start before the
    kernel ahead of it on the stream has ended."""
    stream = _raw_stream(w.dev)
    if mma:
        return _library().q4_matmul_mma(_plan(w, p), x.data_ptr(), s.data_ptr(), y.data_ptr(),
                                        x.shape[0], int(early), stream)
    vec = int(w.out % 4 == 0 and p.data_ptr() % 4 == 0)  # whole 4-byte words of p
    return _library().q4_matmul(x.data_ptr(), p.data_ptr(), s.data_ptr(), y.data_ptr(),
                                x.shape[0], w.d, w.out, int(x.dtype == torch.bfloat16), vec,
                                stream)


# A mirror of the mma variant's launch geometry, which csrc/q4_matmul.cu's
# mma_geometry chooses (the library's q4_geometry returns it; a card test in
# tests/test_torch_cuda.py holds this copy to it): strips of MMA_STRIP
# channels, boxes of MMA_BOX_ROWS packed rows, CL blocks a strip (doubled up
# to 8 while the grid has fewer than two blocks an SM and every block keeps
# two boxes or more), each block a contiguous range of boxes. Its partial
# sums are added block by block in rank order, each block's MMA_WARPS warps
# in order; warp w takes k16 slice w of each box (8 packed rows a slice).
# The CPU tests emulate the kernel's arithmetic over this copy.
MMA_STRIP, MMA_BOX_ROWS, MMA_WARPS, MMA_MAX_CL = 64, 64, 8, 8


def mma_geometry(kp: int, out: int, sms: int = 132) -> Tuple[int, int, list]:
    """-> (strips, CL, each rank's [first box, end box)) of a launch on
    ``sms`` SMs."""
    boxes = -(-kp // MMA_BOX_ROWS)
    strips = -(-out // MMA_STRIP)
    cl = 1
    while cl < MMA_MAX_CL and strips * cl < 2 * sms and boxes >= 4 * cl:
        cl *= 2
    return strips, cl, [(r * boxes // cl, (r + 1) * boxes // cl) for r in range(cl)]


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


__all__ = ["q4_matmul_cuda", "q4_matmul_torch", "q4_matmul_variant", "mma_geometry",
           "unpack_nibbles", "SOURCES", "MAX_ROWS"]
