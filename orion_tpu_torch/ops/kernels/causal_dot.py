"""Causal linear attention: the CUDA kernels' wrappers, their builds, their
plain PyTorch versions, and the autograd Functions that join forward and
backward.

Five kernels, each replacing a TPU kernel of
``orion_tpu/ops/pallas/causal_dot.py``. The fused normalized ones:

- ``causal_dot_norm_cuda`` (``csrc/causal_dot_norm.cu``) <- ``_kernel_norm``
  (``_cdpn_flat``): for phi-mapped q, k [BH, T, Dk] and v [BH, T, Dv]

      out[t] = q_t . S_t / (q_t . z_t + eps)      (input dtype)
      S, z   = the final kv-cumsum state           (fp32)

  seeded by an optional fp32 (S0 [BH, Dk, Dv], z0 [BH, Dk]); with
  ``with_parts`` also the fp32 numerator [BH, T, Dv] and denominator
  [BH, T] (before eps), the residuals of the backward;
- ``causal_dot_dq_den_cuda`` (``csrc/causal_dot_bwd.cu``) <-
  ``_bwd_dq_den_kernel`` (``_cdp_dq_den_flat``): dq;
- ``causal_dot_rev_den_cuda`` (same source) <- ``_bwd_rev_core``
  (``_cdp_rev_den_flat``): dk, dv, dS0, dz0.

The unnormalized ones, under the public op ``causal_dot_product``
(``ops/dispatch.py``):

- ``causal_dot_cuda`` (``csrc/causal_dot_norm.cu``, the same walk with the
  normalizer off) <- ``_kernel`` (``_cdp_flat``): for q, k [BH, T, Dk] and
  v [BH, T, Dv], out[t] = sum_{s<=t} (q_t . k_s) v_s + q_t . S0 in the input
  dtype, and the final S [BH, Dk, Dv] fp32;
- ``causal_dot_rev_cuda`` (``csrc/causal_dot_bwd.cu``) <- ``_bwd_rev_kernel``
  (``_cdp_rev_flat``): the reverse pass seeded by dSf^T, fp32 dk, dv, dS0.

``CausalDotProductFn`` is the counterpart of ``_cdp``: the forward kernel,
then in the backward the same kernel as the dq pass on (g, v, k, S0^T) and
the reverse pass.

``LinearAttentionFn`` is the counterpart of the JAX package's
``_lin_attn_fused`` custom VJP: the forward kernel, then in the backward the
quotient rule in plain torch and the two backward kernels
(``_fused_bwd_core``). The public functions keep the JAX layouts: S0, dS0
[BH, Dk, Dv] and z0, dz0 [BH, Dk], fp32.

Each ``*_cuda`` wrapper launches its kernel or raises, and counts its
launches (``launches``, ``launches_dq``, ``launches_rev``, ``launches_raw``,
``launches_raw_rev``: kernel launches and nothing else). Each ``*_plain`` function is its kernel's function in
plain PyTorch, on any device. The libraries are compiled with ``nvcc`` for
``sm_90a`` at first use (``library.py``: into ``orion_tpu_torch/_build/``,
under a name carrying a hash of the source) and loaded with ``ctypes``.
Nothing here touches CUDA while the module is imported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from orion_tpu_torch.ops.dispatch import DEFAULT_CHUNK, resolve_chunk
from orion_tpu_torch.ops.kernels.library import CSRC, check_launch, load, raise_if_grad
from orion_tpu_torch.ops.kernels.library import stream as _stream
from orion_tpu_torch.ops.linear_attention import _pad_chunks, causal_dot_product_chunked

Tensor = torch.Tensor

# one library per source; "fwd" holds rows 1 and 2, "bwd" rows 3, 4 and 5
SOURCES = {
    "fwd": CSRC / "causal_dot_norm.cu",
    "bwd": CSRC / "causal_dot_bwd.cu",
}
# kernel limits, as in the sources: head widths of at most D_MAX
D_MAX = 128

launches = 0  # forward kernel launches since import (or since a caller reset it)
launches_dq = 0  # dq-pass kernel launches
launches_rev = 0  # reverse-pass kernel launches
launches_raw = 0  # unnormalized forward kernel launches (the public op's forward and dq pass)
launches_raw_rev = 0  # unnormalized reverse-pass kernel launches
_libs: dict = {}
# where a caller that wants gradients goes instead of the bare forward kernels
_GRAD_PATH = "ops.linear_attention.linear_attention / LinearAttentionFn"
_RAW_GRAD_PATH = "ops.causal_dot_product / CausalDotProductFn"

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fwd": {
        "causal_dot_norm_fwd": [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P],
        "causal_dot_fwd": [_P] * 6 + [_I] * 5 + [_P],
    },
    "bwd": {
        "causal_dot_dq_den": [_P] * 7 + [_I] * 5 + [_P],
        "causal_dot_rev_den": [_P] * 11 + [_I] * 5 + [_P],
        "causal_dot_rev": [_P] * 8 + [_I] * 5 + [_P],
    },
}


def _library(name: str):
    if name not in _libs:
        _libs[name] = load(SOURCES[name], _SIGNATURES[name])
    return _libs[name]


def _ptr(x: Optional[Tensor]):
    return x.data_ptr() if x is not None else None


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
    _check_state(s0, z0, bh, dk, dv, "s0", "z0")


def _check_state(s, z, bh, dk, dv, s_name, z_name):
    if (s is None) != (z is None):
        raise ValueError(f"pass both of ({s_name}, {z_name}) or neither")
    if s is not None:
        if s.shape != (bh, dk, dv) or z.shape != (bh, dk):
            raise ValueError(
                f"want {s_name} {(bh, dk, dv)} and {z_name} {(bh, dk)}; got "
                f"{tuple(s.shape)}, {tuple(z.shape)}"
            )
        if s.dtype != torch.float32 or z.dtype != torch.float32:
            raise TypeError(f"{s_name} and {z_name} must be float32")


def _check_s(s, bh, dk, dv, name):
    """The raw kernels' one state: None, or fp32 [BH, Dk, Dv]."""
    if s is not None and (s.shape != (bh, dk, dv) or s.dtype != torch.float32):
        raise ValueError(f"want {name} float32 {(bh, dk, dv)}; got {s.dtype} {tuple(s.shape)}")


def _check_gden(gden: Tensor, bh: int, t: int):
    if gden.shape != (bh, t) or gden.dtype != torch.float32:
        raise ValueError(f"want gden float32 {(bh, t)}; got {gden.dtype} {tuple(gden.shape)}")


# ---------------------------------------------------------------------------
# Row 1: the forward
# ---------------------------------------------------------------------------


def causal_dot_norm_cuda(
    q: Tensor, k: Tensor, v: Tensor,
    s0: Optional[Tensor] = None, z0: Optional[Tensor] = None,
    *, eps: float = 1e-6, with_parts: bool = False,
):
    """Launch the forward kernel on the current stream -> (out, S, z), and
    with ``with_parts`` also (num, den). Raises on anything it does not
    take: an input that requires grad while grad is enabled (the outputs
    would carry none), CPU tensors, mixed devices, a dtype other than
    bf16/fp32, non-contiguous inputs, Dk > 128. The kernel's chunk is a
    constant of its source."""
    global launches
    raise_if_grad([q, k, v, s0, z0], _GRAD_PATH)
    _check(q, k, v, s0, z0)
    check_launch("causal_dot_norm_cuda", [q, k, v], [s0, z0])
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if dk > D_MAX:
        raise ValueError(f"Dk {dk} > {D_MAX}, the kernel's limit")
    out = torch.empty_like(v)
    sf = torch.empty(bh, dk, dv, dtype=torch.float32, device=q.device)
    zf = torch.empty(bh, dk, dtype=torch.float32, device=q.device)
    num = den = None
    if with_parts:
        num = torch.empty(bh, t, dv, dtype=torch.float32, device=q.device)
        den = torch.empty(bh, t, dtype=torch.float32, device=q.device)
    lib = _library("fwd")
    with torch.cuda.device(q.device):
        err = lib.causal_dot_norm_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(s0), _ptr(z0),
            out.data_ptr(), sf.data_ptr(), zf.data_ptr(), _ptr(num), _ptr(den),
            bh, t, dk, dv, int(q.dtype == torch.bfloat16), eps, _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"causal_dot_norm kernel failed: cudaError_t {err}")
    launches += 1
    return (out, sf, zf, num, den) if with_parts else (out, sf, zf)


def causal_dot_norm_plain(
    q: Tensor, k: Tensor, v: Tensor,
    s0: Optional[Tensor] = None, z0: Optional[Tensor] = None,
    *, eps: float = 1e-6, chunk: Optional[int] = None, with_parts: bool = False,
):
    """The forward kernel's function in plain PyTorch (the chunked form with
    the strict-left-fold normalizer), on any device -> (out, S, z), and
    with ``with_parts`` also (num, den). Differentiable by autograd."""
    _check(q, k, v, s0, z0)
    qf = q.float()
    # fp32 operands, so the numerator stays fp32 up to the one final
    # rounding, as in the kernel (and the TPU kernel)
    num, zcum, sf, zf = causal_dot_product_chunked(
        qf, k.float(), v.float(), chunk=resolve_chunk(chunk),
        initial_state=s0, initial_z=z0, return_zcum=True,
    )
    den = (qf * zcum).sum(dim=-1)
    out = (num / (den[..., None] + eps)).to(q.dtype)
    return (out, sf, zf, num, den) if with_parts else (out, sf, zf)


# ---------------------------------------------------------------------------
# Rows 3 and 4: the backward passes
# ---------------------------------------------------------------------------


def _check_bwd(g, v, k, q=None):
    if g.dim() != 3 or v.shape != g.shape or k.dim() != 3 or k.shape[:2] != g.shape[:2]:
        raise ValueError(
            f"want g, v [BH, T, Dv] and k [BH, T, Dk]; got {tuple(g.shape)}, "
            f"{tuple(v.shape)}, {tuple(k.shape)}"
        )
    if q is not None and q.shape != k.shape:
        raise ValueError(f"want q like k {tuple(k.shape)}; got {tuple(q.shape)}")
    bh, t, dv = g.shape
    dk = k.shape[-1]
    if min(bh, t, dk, dv) < 1:
        raise ValueError(f"empty input {tuple(g.shape)}, {tuple(k.shape)}")
    return bh, t, dk, dv


def causal_dot_dq_den_cuda(
    g: Tensor, v: Tensor, k: Tensor, gden: Tensor,
    s0: Optional[Tensor] = None, z0: Optional[Tensor] = None,
) -> Tensor:
    """Launch the dq-pass kernel on the current stream -> dq [BH, T, Dk] in
    g's dtype: g = d out / d num in the input dtype [BH, T, Dv], gden =
    d out / d den [BH, T] fp32, (s0, z0) the forward's initial state. Raises
    on anything it does not take, as ``causal_dot_norm_cuda``."""
    global launches_dq
    bh, t, dk, dv = _check_bwd(g, v, k)
    _check_gden(gden, bh, t)
    _check_state(s0, z0, bh, dk, dv, "s0", "z0")
    check_launch("causal_dot_dq_den_cuda", [g, v, k], [gden, s0, z0])
    if dv > D_MAX:
        raise ValueError(f"Dv {dv} > {D_MAX}, the kernel's limit")
    dq = torch.empty_like(k)
    lib = _library("bwd")
    with torch.cuda.device(g.device):
        err = lib.causal_dot_dq_den(
            g.data_ptr(), v.data_ptr(), k.data_ptr(), gden.data_ptr(), _ptr(s0), _ptr(z0),
            dq.data_ptr(), bh, t, dk, dv, int(g.dtype == torch.bfloat16), _stream(g.device),
        )
    if err != 0:
        raise RuntimeError(f"causal_dot_dq_den kernel failed: cudaError_t {err}")
    launches_dq += 1
    return dq


def causal_dot_rev_den_cuda(
    q: Tensor, k: Tensor, v: Tensor, g: Tensor, gden: Tensor,
    gsf: Optional[Tensor] = None, gzf: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Launch the reverse-pass kernel on the current stream -> (dk, dv in
    the input dtype, dS0 [BH, Dk, Dv], dz0 [BH, Dk] fp32). (gsf, gzf) are
    the cotangents of the forward's final state, None for zeros. Raises on
    anything it does not take, as ``causal_dot_norm_cuda``."""
    global launches_rev
    bh, t, dk, dv = _check_bwd(g, v, k, q)
    _check_gden(gden, bh, t)
    _check_state(gsf, gzf, bh, dk, dv, "gsf", "gzf")
    check_launch("causal_dot_rev_den_cuda", [q, k, v, g], [gden, gsf, gzf])
    if dk > D_MAX or dv > D_MAX:
        raise ValueError(f"Dk {dk} or Dv {dv} > {D_MAX}, the kernel's limit")
    dk_out, dv_out = torch.empty_like(k), torch.empty_like(v)
    ds0 = torch.empty(bh, dk, dv, dtype=torch.float32, device=q.device)
    dz0 = torch.empty(bh, dk, dtype=torch.float32, device=q.device)
    lib = _library("bwd")
    with torch.cuda.device(q.device):
        err = lib.causal_dot_rev_den(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), gden.data_ptr(),
            _ptr(gsf), _ptr(gzf), dk_out.data_ptr(), dv_out.data_ptr(), ds0.data_ptr(),
            dz0.data_ptr(), bh, t, dk, dv, int(q.dtype == torch.bfloat16), _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"causal_dot_rev_den kernel failed: cudaError_t {err}")
    launches_rev += 1
    return dk_out, dv_out, ds0, dz0


def _chunks(t: int, chunk: int):
    return [slice(c, c + chunk) for c in range(0, t, chunk)]


def _fwd_walk(x, y, w, st, gd=None, z=None):
    """The forward-walking chunk recurrence of ``_kernel`` and
    ``_bwd_dq_den_kernel`` on fp32 operands padded to whole chunks: per chunk

        out = where(s <= t, x y^T, 0) w + x St  (+ gd (z + prefix sums of w))
        St += y^T w                             (z += the chunk's sum of w)

    x, y [BH, T, dx], w [BH, T, dw], St [BH, dx, dw]; the denominator part
    only with ``gd`` [BH, T, 1] and ``z`` [BH, dw]. Returns (out, St)."""
    c = DEFAULT_CHUNK
    causal = torch.tril(torch.ones(c, c, dtype=torch.bool, device=x.device))
    outs = []
    for sl in _chunks(x.shape[1], c):
        xc, yc, wc = x[:, sl], y[:, sl], w[:, sl]
        o = torch.where(causal, xc @ yc.transpose(1, 2), 0.0) @ wc + xc @ st
        if gd is not None:
            zcum = z[:, None, :] + torch.cumsum(wc, dim=1)
            o = o + gd[:, sl] * zcum
            z = zcum[:, -1]
        outs.append(o)
        st = st + yc.transpose(1, 2) @ wc
    return torch.cat(outs, dim=1), st


def _rev_walk(q, k, v, g, r, gd=None, zr=None):
    """The last-to-first chunk recurrence of ``_bwd_rev_core`` on fp32
    operands padded to whole chunks, carrying R [BH, Dv, Dk] (and, with
    ``gd`` [BH, T, 1], zr [BH, Dk]):

        dk[t] = sum_{s>=t} (v_t . g_s) q_s + v_t R (+ zr + in-chunk suffix of gd q)
        dv[t] = sum_{s>=t} (k_t . q_s) g_s + k_t R^T
        R += g^T q  (zr += sum gd q)

    Returns fp32 (dk, dv, R_final, zr_final)."""
    c = DEFAULT_CHUNK
    anti = torch.triu(torch.ones(c, c, dtype=torch.bool, device=q.device))  # s >= t
    anti_f = anti.float()
    dks, dvs = [], []
    for sl in reversed(_chunks(q.shape[1], c)):
        qc, kc, vc, gc = q[:, sl], k[:, sl], v[:, sl], g[:, sl]
        svg = torch.where(anti, vc @ gc.transpose(1, 2), 0.0)
        skq = torch.where(anti, kc @ qc.transpose(1, 2), 0.0)
        dk = svg @ qc + vc @ r
        if gd is not None:
            gq = gd[:, sl] * qc
            dk = dk + zr[:, None, :] + anti_f @ gq
            zr = zr + gq.sum(dim=1)
        dks.append(dk)
        dvs.append(skq @ gc + kc @ r.transpose(1, 2))
        r = r + gc.transpose(1, 2) @ qc
    return torch.cat(dks[::-1], dim=1), torch.cat(dvs[::-1], dim=1), r, zr


def causal_dot_dq_den_plain(
    g: Tensor, v: Tensor, k: Tensor, gden: Tensor,
    s0: Optional[Tensor] = None, z0: Optional[Tensor] = None,
) -> Tensor:
    """The dq-pass kernel's function in plain PyTorch, on any device: the
    forward-walking chunk recurrence of ``_bwd_dq_den_kernel``,

        dq[t] = sum_{s<=t} (g_t . v_s) k_s + g_t S_t^T + gden_t (z0 + sum_{s<=t} k_s)

    with S carried from S0 over earlier chunks; fp32 sums, dq in g's dtype."""
    bh, t, dk, dv = _check_bwd(g, v, k)
    _check_gden(gden, bh, t)
    _check_state(s0, z0, bh, dk, dv, "s0", "z0")
    c = DEFAULT_CHUNK
    gf, vf, kf = (_pad_chunks(x.float(), c) for x in (g, v, k))
    st = torch.zeros(bh, dv, dk, device=g.device) if s0 is None else s0.transpose(1, 2)
    z = torch.zeros(bh, dk, device=g.device) if z0 is None else z0
    dq, _ = _fwd_walk(gf, vf, kf, st, _pad_chunks(gden[..., None], c), z)
    return dq[:, :t].to(g.dtype)


def causal_dot_rev_den_plain(
    q: Tensor, k: Tensor, v: Tensor, g: Tensor, gden: Tensor,
    gsf: Optional[Tensor] = None, gzf: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The reverse-pass kernel's function in plain PyTorch, on any device:
    the last-to-first chunk recurrence of ``_bwd_rev_core``, carrying
    R = gsf^T + sum_{s>=t} g_s (x) q_s and zr = gzf + sum_{s>=t} gden_s q_s,

        dk[t] = sum_{s>=t} (v_t . g_s) q_s + v_t R + zr + (in-chunk suffix of gden q)
        dv[t] = sum_{s>=t} (k_t . q_s) g_s + k_t R^T

    -> (dk, dv in the input dtype, dS0 = R_final^T, dz0 = zr_final, fp32)."""
    bh, t, dk, dv = _check_bwd(g, v, k, q)
    _check_gden(gden, bh, t)
    _check_state(gsf, gzf, bh, dk, dv, "gsf", "gzf")
    c = DEFAULT_CHUNK
    qf, kf, vf, gf = (_pad_chunks(x.float(), c) for x in (q, k, v, g))
    r = torch.zeros(bh, dv, dk, device=q.device) if gsf is None else gsf.transpose(1, 2)
    zr = torch.zeros(bh, dk, device=q.device) if gzf is None else gzf
    dk_out, dv_out, r, zr = _rev_walk(qf, kf, vf, gf, r, _pad_chunks(gden[..., None], c), zr)
    return (dk_out[:, :t].to(k.dtype), dv_out[:, :t].to(v.dtype),
            r.transpose(1, 2).contiguous(), zr)


# ---------------------------------------------------------------------------
# Rows 2 and 5: the public op's forward (and dq pass) and reverse pass
# ---------------------------------------------------------------------------


def causal_dot_cuda(q: Tensor, k: Tensor, v: Tensor,
                    s0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Launch the unnormalized forward kernel on the current stream ->
    (out [BH, T, Dv] in the input dtype, S [BH, Dk, Dv] fp32) for q, k
    [BH, T, Dk], v [BH, T, Dv] and an optional fp32 S0 [BH, Dk, Dv]. Raises
    on anything it does not take, as ``causal_dot_norm_cuda``."""
    global launches_raw
    raise_if_grad([q, k, v, s0], _RAW_GRAD_PATH)
    _check(q, k, v, None, None)
    bh, t, dk = q.shape
    dv = v.shape[-1]
    _check_s(s0, bh, dk, dv, "s0")
    check_launch("causal_dot_cuda", [q, k, v], [s0])
    if dk > D_MAX:
        raise ValueError(f"Dk {dk} > {D_MAX}, the kernel's limit")
    out = torch.empty_like(v)
    sf = torch.empty(bh, dk, dv, dtype=torch.float32, device=q.device)
    lib = _library("fwd")
    with torch.cuda.device(q.device):
        err = lib.causal_dot_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(s0), out.data_ptr(), sf.data_ptr(),
            bh, t, dk, dv, int(q.dtype == torch.bfloat16), _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"causal_dot kernel failed: cudaError_t {err}")
    launches_raw += 1
    return out, sf


def causal_dot_plain(q: Tensor, k: Tensor, v: Tensor,
                     s0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The unnormalized forward kernel's function in plain PyTorch, on any
    device: the chunk recurrence of ``_kernel`` in fp32 -> (out in the input
    dtype, S fp32)."""
    _check(q, k, v, None, None)
    bh, t, dk = q.shape
    dv = v.shape[-1]
    _check_s(s0, bh, dk, dv, "s0")
    c = DEFAULT_CHUNK
    qf, kf, vf = (_pad_chunks(x.float(), c) for x in (q, k, v))
    st = torch.zeros(bh, dk, dv, device=q.device) if s0 is None else s0
    out, sf = _fwd_walk(qf, kf, vf, st)
    return out[:, :t].to(q.dtype), sf


def causal_dot_rev_cuda(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                        gsf: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the unnormalized reverse-pass kernel on the current stream ->
    fp32 (dk [BH, T, Dk], dv [BH, T, Dv], dS0 [BH, Dk, Dv]): g is d out in
    the input dtype, gsf [BH, Dk, Dv] fp32 the cotangent of the final state
    (the walk's seed R = gsf^T), None for zeros. Raises on anything it does
    not take, as ``causal_dot_norm_cuda``."""
    global launches_raw_rev
    bh, t, dk, dv = _check_bwd(g, v, k, q)
    _check_s(gsf, bh, dk, dv, "gsf")
    check_launch("causal_dot_rev_cuda", [q, k, v, g], [gsf])
    if dk > D_MAX or dv > D_MAX:
        raise ValueError(f"Dk {dk} or Dv {dv} > {D_MAX}, the kernel's limit")
    f32 = dict(dtype=torch.float32, device=q.device)
    dk_out, dv_out = torch.empty(bh, t, dk, **f32), torch.empty(bh, t, dv, **f32)
    ds0 = torch.empty(bh, dk, dv, **f32)
    lib = _library("bwd")
    with torch.cuda.device(q.device):
        err = lib.causal_dot_rev(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), _ptr(gsf),
            dk_out.data_ptr(), dv_out.data_ptr(), ds0.data_ptr(), bh, t, dk, dv,
            int(q.dtype == torch.bfloat16), _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"causal_dot_rev kernel failed: cudaError_t {err}")
    launches_raw_rev += 1
    return dk_out, dv_out, ds0


def causal_dot_rev_plain(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                         gsf: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """The unnormalized reverse-pass kernel's function in plain PyTorch, on
    any device: ``_bwd_rev_core``'s walk without the denominator terms,
    seeded by R = gsf^T -> fp32 (dk, dv, dS0 = R_final^T)."""
    bh, t, dk, dv = _check_bwd(g, v, k, q)
    _check_s(gsf, bh, dk, dv, "gsf")
    qf, kf, vf, gf = (_pad_chunks(x.float(), DEFAULT_CHUNK) for x in (q, k, v, g))
    r = torch.zeros(bh, dv, dk, device=q.device) if gsf is None else gsf.transpose(1, 2)
    dk_out, dv_out, r, _ = _rev_walk(qf, kf, vf, gf, r)
    return dk_out[:, :t], dv_out[:, :t], r.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------


def quotient_rule(
    gout: Tensor, num: Tensor, den: Tensor, eps: float, dtype: torch.dtype
) -> Tuple[Tensor, Tensor]:
    """The cotangents of the forward's fp32 parts from that of its output
    out = num / (den + eps), as ``_lin_attn_fused_bwd``: gnum = gout / d
    cast to the input dtype (the backward kernels' operand), and gden =
    -(gout . num) / d^2 in fp32 [BH, T]."""
    d = den + eps
    g32 = gout.float()
    gnum = (g32 / d[..., None]).to(dtype).contiguous()
    gden = (-(g32 * num).sum(dim=-1) / (d * d)).contiguous()
    return gnum, gden


class LinearAttentionFn(torch.autograd.Function):
    """Normalized causal linear attention with its backward on the kernels:
    the counterpart of the JAX package's ``_lin_attn_fused`` custom VJP.

    ``apply(q, k, v, s0, z0, eps)`` on flat contiguous q, k [BH, T, Dk],
    v [BH, T, Dv] and an optional fp32 (S0, z0) -> (out, S, z). The forward
    launches the forward kernel and saves (q, k, v, s0, z0, num, den); the
    backward does the quotient rule of ``_lin_attn_fused_bwd`` in plain
    torch (as XLA does in the reference), then launches the dq pass and the
    reverse pass (``_fused_bwd_core``). It returns grads for q, k, v, and
    for S0 and z0 when they were given. It calls the three ``*_cuda``
    wrappers by their module names, so a test can stand their plain
    versions in for them on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, s0, z0, eps):
        out, sf, zf, num, den = causal_dot_norm_cuda(q, k, v, s0, z0, eps=eps, with_parts=True)
        ctx.save_for_backward(q, k, v, s0, z0, num, den)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return out, sf, zf

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout, gsf, gzf):
        q, k, v, s0, z0, num, den = ctx.saved_tensors
        bh, _, dk = q.shape
        dv = v.shape[-1]
        if gout is None:
            gout = torch.zeros_like(v)
        gnum, gden = quotient_rule(gout, num, den, ctx.eps, q.dtype)
        if gsf is not None or gzf is not None:  # the final state's cotangents
            zeros = lambda *shape: torch.zeros(*shape, device=q.device)  # noqa: E731
            gsf = zeros(bh, dk, dv) if gsf is None else gsf.float().contiguous()
            gzf = zeros(bh, dk) if gzf is None else gzf.float().contiguous()
        dq = causal_dot_dq_den_cuda(gnum, v, k, gden, s0, z0)
        dk_, dv_, ds0, dz0 = causal_dot_rev_den_cuda(q, k, v, gnum, gden, gsf, gzf)
        return (
            dq, dk_, dv_,
            ds0 if s0 is not None else None, dz0 if z0 is not None else None,
            None,
        )


class CausalDotProductFn(torch.autograd.Function):
    """The unnormalized causal dot product with its backward on the kernels:
    the counterpart of the JAX package's ``_cdp`` custom VJP.

    ``apply(q, k, v, s0)`` on flat contiguous q, k [BH, T, Dk], v [BH, T,
    Dv] of one dtype and an optional fp32 S0 [BH, Dk, Dv] -> (out, S). The
    forward launches the unnormalized forward kernel; the backward casts g
    to q's dtype (``_cdp_bwd``), runs the same kernel as the dq pass on (g,
    v, k) with S0^T carried in, and the reverse pass seeded by dSf^T (zeros
    when the state got no cotangent), then casts dq, dk, dv to the input
    dtypes. It returns a grad for S0 only when one was given. It calls the
    two ``*_cuda`` wrappers by their module names, so a test can stand their
    plain versions in for them on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, s0):
        out, sf = causal_dot_cuda(q, k, v, s0)
        ctx.save_for_backward(q, k, v, s0)
        ctx.set_materialize_grads(False)
        return out, sf

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout, gsf):
        q, k, v, s0 = ctx.saved_tensors
        if gout is None:
            gout = torch.zeros_like(v)
        g = gout.to(q.dtype).contiguous()
        s0t = s0.transpose(1, 2).contiguous() if s0 is not None else None
        dq, _ = causal_dot_cuda(g, v, k, s0t)
        gsf = gsf.float().contiguous() if gsf is not None else None
        dk, dv, ds0 = causal_dot_rev_cuda(q, k, v, g, gsf)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds0 if s0 is not None else None


__all__ = [
    "causal_dot_cuda", "causal_dot_plain", "causal_dot_rev_cuda", "causal_dot_rev_plain",
    "CausalDotProductFn",
    "causal_dot_norm_cuda", "causal_dot_norm_plain",
    "causal_dot_dq_den_cuda", "causal_dot_dq_den_plain",
    "causal_dot_rev_den_cuda", "causal_dot_rev_den_plain",
    "LinearAttentionFn", "quotient_rule", "SOURCES",
]
