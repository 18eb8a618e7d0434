"""Fused normalized causal linear attention: the CUDA kernel's wrapper, its
build, and its plain PyTorch version.

The kernel (``orion_tpu_torch/csrc/causal_dot_norm.cu``) replaces the TPU
kernel ``orion_tpu/ops/pallas/causal_dot.py::_kernel_norm`` (launched by
``_cdpn_flat``): for phi-mapped q, k [BH, T, Dk] and v [BH, T, Dv] it writes

    out[t] = q_t . S_t / (q_t . z_t + eps)      (input dtype)
    S, z   = the final kv-cumsum state           (fp32)

seeded by an optional fp32 (S0 [BH, Dk, Dv], z0 [BH, Dk]).

The library is compiled with ``nvcc`` for ``sm_90a`` at first use into
``orion_tpu_torch/_build/`` (its name carries a hash of the source, so an
edited source is rebuilt) and loaded with ``ctypes``. Nothing here touches
CUDA while the module is imported.

``causal_dot_norm_cuda`` launches the kernel or raises;
``causal_dot_norm_plain`` is the plain version on any device.
``ops/linear_attention.py::linear_attention`` chooses between them
(``ops/dispatch.py::resolve``). ``launches`` counts kernel launches and
nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import torch

from orion_tpu_torch.ops.dispatch import resolve_chunk
from orion_tpu_torch.ops.linear_attention import causal_dot_product_chunked

Tensor = torch.Tensor

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "causal_dot_norm.cu"
BUILD_DIR = _PKG / "_build"
# kernel limits, as in the source: head width of q/k at most DK_MAX
DK_MAX = 128

launches = 0  # kernel launches since import (or since a caller reset it)
_lib = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the kernel builds on the card's host")


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libcausal_dot_norm-{digest}.so"


def _build_command(out: Path) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(SOURCE),
    ]


def build() -> Tuple[Path, str]:
    """Compile the library if this source has no build yet. Returns (path,
    compiler output); the output is empty when the build already existed.
    Writes to a temporary name and renames, so concurrent builds are safe."""
    path = _library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            _build_command(Path(tmp)), capture_output=True, text=True, timeout=600
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.causal_dot_norm_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: Tensor, k: Tensor, v: Tensor, s0: Optional[Tensor], z0: Optional[Tensor]):
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(
            f"want q, k [BH, T, Dk] and v [BH, T, Dv]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if min(bh, t, dk, dv) < 1:
        raise ValueError(f"empty input {tuple(q.shape)}, {tuple(v.shape)}")
    if (s0 is None) != (z0 is None):
        raise ValueError("pass both of (s0, z0) or neither")
    if s0 is not None:
        if s0.shape != (bh, dk, dv) or z0.shape != (bh, dk):
            raise ValueError(
                f"want s0 {(bh, dk, dv)} and z0 {(bh, dk)}; got "
                f"{tuple(s0.shape)}, {tuple(z0.shape)}"
            )
        if s0.dtype != torch.float32 or z0.dtype != torch.float32:
            raise TypeError("s0 and z0 must be float32")


def causal_dot_norm_cuda(
    q: Tensor, k: Tensor, v: Tensor,
    s0: Optional[Tensor] = None, z0: Optional[Tensor] = None,
    *, eps: float = 1e-6,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the kernel on the current stream -> (out, S, z). Raises on
    anything it does not take: CPU tensors, mixed devices, a dtype other
    than bf16/fp32, non-contiguous inputs, Dk > 128. The kernel's chunk is
    a constant of its source."""
    global launches
    _check(q, k, v, s0, z0)
    tensors = [q, k, v] + ([s0, z0] if s0 is not None else [])
    if q.device.type != "cuda":
        raise RuntimeError(
            f"causal_dot_norm_cuda needs CUDA tensors; got {q.device} "
            "(backend='torch' runs the plain version anywhere)"
        )
    if any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must lie on one device")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share dtype bf16 or fp32; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("inputs must be contiguous")
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if dk > DK_MAX:
        raise ValueError(f"Dk {dk} > {DK_MAX}, the kernel's limit")
    out = torch.empty_like(v)
    sf = torch.empty(bh, dk, dv, dtype=torch.float32, device=q.device)
    zf = torch.empty(bh, dk, dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.causal_dot_norm_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            s0.data_ptr() if s0 is not None else None,
            z0.data_ptr() if z0 is not None else None,
            out.data_ptr(), sf.data_ptr(), zf.data_ptr(),
            bh, t, dk, dv, int(q.dtype == torch.bfloat16), eps, stream,
        )
    if err != 0:
        raise RuntimeError(f"causal_dot_norm kernel failed: cudaError_t {err}")
    launches += 1
    return out, sf, zf


def causal_dot_norm_plain(
    q: Tensor, k: Tensor, v: Tensor,
    s0: Optional[Tensor] = None, z0: Optional[Tensor] = None,
    *, eps: float = 1e-6, chunk: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The kernel's function in plain PyTorch (the chunked form with the
    strict-left-fold normalizer), on any device -> (out, S, z)."""
    _check(q, k, v, s0, z0)
    qf = q.float()
    # fp32 operands, so the numerator stays fp32 up to the one final
    # rounding, as in the kernel (and the TPU kernel)
    num, zcum, sf, zf = causal_dot_product_chunked(
        qf, k.float(), v.float(), chunk=resolve_chunk(chunk),
        initial_state=s0, initial_z=z0, return_zcum=True,
    )
    den = (qf * zcum).sum(dim=-1, keepdim=True)
    return (num / (den + eps)).to(q.dtype), sf, zf


__all__ = ["causal_dot_norm_cuda", "causal_dot_norm_plain", "build", "launches", "SOURCE"]
