"""Causal linear attention in PyTorch: the three equivalent forms plus the
normalized op the model calls.

The port's counterpart of ``orion_tpu/ops/linear_attention.py``:

1. ``causal_dot_product_eager``   -- materializes the T x T scores; the parity
   reference for every other path.
2. ``causal_dot_product_chunked`` -- chunked kv-cumsum recurrence: masked C x C
   intra-chunk products plus a carried state S = sum k (x) v. With
   ``return_zcum`` the key normalizer z rides the same carry as a strict
   left fold, so a prompt split at chunk boundaries replays the same sums.
3. ``recurrent_step``             -- the O(1)-state decode update.

``linear_attention`` is the normalized op: on CUDA tensors it runs the fused
kernel ``ops/kernels/causal_dot.py`` (``csrc/causal_dot_norm.cu``), and when
a gradient is wanted it goes through ``causal_dot.LinearAttentionFn``, whose
backward runs the two backward kernels (``csrc/causal_dot_bwd.cu``); its
plain version is the chunked form of 2, differentiated by autograd.

Conventions as in the JAX package: q, k are post-feature-map with shape
[..., T, Dk]; v is [..., T, Dv]; states S [..., Dk, Dv] and z [..., Dk] are
fp32; all accumulation is fp32 and outputs take the input dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from orion_tpu_torch.ops.dispatch import resolve

Tensor = torch.Tensor
_DEFAULT_EPS = 1e-6


def causal_dot_product_eager(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """out[t] = sum_{s<=t} (q_t . k_s) v_s, materializing the T x T scores.
    fp32 throughout."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = qf @ kf.transpose(-1, -2)
    t = q.shape[-2]
    mask = torch.tril(torch.ones(t, t, dtype=torch.float32, device=q.device))
    return ((scores * mask) @ vf).to(q.dtype)


def _pad_chunks(x: Tensor, chunk: int) -> Tensor:
    rem = (-x.shape[-2]) % chunk
    if rem:
        x = torch.nn.functional.pad(x, (0, 0, 0, rem))
    return x


def causal_dot_product_chunked(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    chunk: int = 64,
    return_state: bool = False,
    initial_state: Optional[Tensor] = None,
    initial_z: Optional[Tensor] = None,
    return_zcum: bool = False,
):
    """Chunked causal dot product: a loop over sequence chunks.

    Per chunk c (size C), with carried state S = sum_{s < c*C} k_s (x) v_s:
        intra = (Q_c K_c^T * M) V_c      (M = causal mask, s <= t)
        inter = Q_c S
        S    += K_c^T V_c
    Returns ``out`` (input dtype), ``(out, S)`` with ``return_state``, or
    with ``return_zcum`` ``(out, zcum, S, z)``: zcum [..., T, Dk] holds the
    per-position prefix sums z + sum_{s<=t} k_s, taken per chunk as
    ``z + cumsum(k_chunk)`` with z carried -- a strict left fold over chunk
    totals, so splitting the sequence at chunk boundaries and threading
    (S, z) gives the same sums in the same order.
    """
    orig_dtype = q.dtype
    t = q.shape[-2]
    qf = _pad_chunks(q.float(), chunk)
    kf = _pad_chunks(k.float(), chunk)
    vf = _pad_chunks(v.float(), chunk)
    n = qf.shape[-2] // chunk
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.float32, device=q.device))

    s = (
        torch.zeros(*kf.shape[:-2], kf.shape[-1], vf.shape[-1],
                    dtype=torch.float32, device=q.device)
        if initial_state is None
        else initial_state.float()
    )
    z = None
    if return_zcum:
        z = (
            torch.zeros_like(kf[..., 0, :])
            if initial_z is None
            else initial_z.float()
        )
    outs, zcums = [], []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        qi, ki, vi = qf[..., sl, :], kf[..., sl, :], vf[..., sl, :]
        scores = (qi @ ki.transpose(-1, -2)) * mask
        intra = scores @ vi
        inter = qi @ s
        s = s + ki.transpose(-1, -2) @ vi
        outs.append(intra + inter)
        if return_zcum:
            zc = z[..., None, :] + torch.cumsum(ki, dim=-2)
            z = zc[..., -1, :]
            zcums.append(zc)
    out = torch.cat(outs, dim=-2)[..., :t, :].to(orig_dtype)
    if return_zcum:
        return out, torch.cat(zcums, dim=-2)[..., :t, :], s, z
    if return_state:
        return out, s
    return out


def kv_state(
    k: Tensor, v: Tensor, initial_state: Optional[Tuple[Tensor, Tensor]] = None
) -> Tuple[Tensor, Tensor]:
    """Final kv-cumsum state (S = sum_s k_s (x) v_s, z = sum_s k_s), fp32."""
    kf, vf = k.float(), v.float()
    s = kf.transpose(-1, -2) @ vf
    z = kf.sum(dim=-2)
    if initial_state is not None:
        s0, z0 = initial_state
        s = s + s0.float()
        z = z + z0.float()
    return s, z


def recurrent_step(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    state: Tuple[Tensor, Tensor],
    eps: float = _DEFAULT_EPS,
) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """One decode step: S += k (x) v, z += k, out = (q.S) / (q.z + eps).

    q, k: [..., Dk]; v: [..., Dv]; state = (S [..., Dk, Dv], z [..., Dk]),
    fp32. The output equals row t of ``linear_attention`` over the prefix.
    """
    s, z = state
    qf, kf, vf = q.float(), k.float(), v.float()
    sf = s.float() + kf[..., :, None] * vf[..., None, :]
    zf = z.float() + kf
    # a product and a sum, not a batched matmul: cuBLAS rounds a row of the
    # batched product by the batch count, and the sum's reduction shape does
    # not read it, so a row's step is bitwise the same in any batch
    num = (qf[..., :, None] * sf).sum(dim=-2)
    den = (qf * zf).sum(dim=-1, keepdim=True) + eps
    return (num / den).to(q.dtype), (sf, zf)


def init_recurrent_state(
    batch_shape, dk: int, dv: int, device=None
) -> Tuple[Tensor, Tensor]:
    """Zero decode state (S, z) in fp32."""
    return (
        torch.zeros(*batch_shape, dk, dv, dtype=torch.float32, device=device),
        torch.zeros(*batch_shape, dk, dtype=torch.float32, device=device),
    )


def linear_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    backend: str = "auto",
    chunk: Optional[int] = None,
    eps: float = _DEFAULT_EPS,
    initial_state: Optional[Tuple[Tensor, Tensor]] = None,
    return_state: bool = False,
):
    """Normalized causal linear attention over feature-mapped q, k.

    out[t] = (q_t . S_t) / (q_t . z_t + eps), S_t = sum_{s<=t} k_s (x) v_s,
    z_t = sum_{s<=t} k_s, optionally seeded by ``initial_state=(S0, z0)``;
    ``return_state`` also returns the final fp32 (S, z). ``backend`` picks
    the fused CUDA kernels or their plain version (ops/dispatch.py); ``chunk``
    sizes only the plain version. Differentiable through q, k, v, the
    initial state and the returned state on either backend: with grad
    enabled and an input that requires it, the kernel backend runs
    ``LinearAttentionFn`` (forward kernel, then the backward kernels).
    """
    from orion_tpu_torch.ops.kernels import causal_dot

    batch_shape = q.shape[:-2]
    t, dk, dv = q.shape[-2], q.shape[-1], v.shape[-1]
    qf = q.reshape(-1, t, dk).contiguous()
    kf = k.reshape(-1, t, dk).contiguous()
    vf = v.reshape(-1, t, dv).contiguous()
    s0 = z0 = None
    if initial_state is not None:
        s0 = initial_state[0].float().reshape(-1, dk, dv).contiguous()
        z0 = initial_state[1].float().reshape(-1, dk).contiguous()

    if resolve(backend, q.device) == "torch":
        out, sf, zf = causal_dot.causal_dot_norm_plain(qf, kf, vf, s0, z0, eps=eps, chunk=chunk)
    elif torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (qf, kf, vf, s0, z0)
    ):
        out, sf, zf = causal_dot.LinearAttentionFn.apply(qf, kf, vf, s0, z0, eps)
    else:
        out, sf, zf = causal_dot.causal_dot_norm_cuda(qf, kf, vf, s0, z0, eps=eps)
    out = out.reshape(*batch_shape, t, dv)
    if return_state:
        return out, (sf.reshape(*batch_shape, dk, dv), zf.reshape(*batch_shape, dk))
    return out


def linear_attention_noncausal(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    eps: float = _DEFAULT_EPS,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Bidirectional linear attention: phi(Q)(phi(K)^T V) / (phi(Q).sum phi(k)),
    with an optional boolean key padding mask [..., T]."""
    qf, kf, vf = q.float(), k.float(), v.float()
    if mask is not None:
        m = mask.float()[..., None]
        kf = kf * m
        vf = vf * m
    kv = kf.transpose(-1, -2) @ vf
    z = kf.sum(dim=-2)
    num = qf @ kv
    den = (qf * z[..., None, :]).sum(dim=-1, keepdim=True) + eps
    return (num / den).to(q.dtype)


__all__ = [
    "causal_dot_product_eager",
    "causal_dot_product_chunked",
    "kv_state",
    "recurrent_step",
    "init_recurrent_state",
    "linear_attention",
    "linear_attention_noncausal",
]
