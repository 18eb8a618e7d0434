"""Chunked fused linear cross-entropy: the LM head matmul and the softmax
cross entropy computed together, one sequence chunk at a time, so the full
``[B, T, V]`` fp32 logits tensor never exists in device memory.

The port's counterpart of ``orion_tpu/ops/fused_ce.py``: the same chunking
rule (``pick_n_chunks``, ``chunk_plan``), the same residuals (the inputs and
the [B, T] fp32 log-sum-exp, never the logits), the same backward (each
chunk's logits recomputed, ``softmax - onehot`` scaled by the cotangent).
The chunk products are plain large matrix products outside any kernel, so
they go to ``torch.mm``. The reference's dtypes are kept: operands in the
compute dtype with fp32 accumulation into fp32 logits; ``dlog`` cast to the
compute dtype before its two products; ``dw`` accumulated in fp32; ``dx`` in
the compute dtype.

The head is the tied embedding table [V, D] or the untied
``lm_head_kernel`` [D, V], which enters as its transpose. The
sequence-parallel variant is not ported (ROADMAP.md queue A, item 12).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# ~rows of each chunk matmul, as the reference: the [rows, V] fp32 logits
# block stays ~256 MB at V 32k
_TARGET_ROWS = 2048


def fused_ce_ok(model) -> bool:
    """Is the fused head+CE path applicable to this model? Everywhere
    except quantized models (decode only: ``orion_tpu_torch/quant.py``)."""
    return not getattr(model, "quant", "")


def pick_n_chunks(batch: int, seq: int) -> int:
    """Largest divisor of ``seq`` keeping ~_TARGET_ROWS tokens per chunk.
    Returns 1 when ``seq`` has no usable divisor -- callers that must never
    materialize the full logits use ``chunk_plan`` (pad-and-chunk)."""
    cap = max(1, (batch * seq) // _TARGET_ROWS)
    best = 1
    for d in range(1, seq + 1):
        if d > cap:
            break
        if seq % d == 0:
            best = d
    return best


def chunk_plan(batch: int, seq: int) -> Tuple[int, int]:
    """(n_chunks, padded_seq): ``pick_n_chunks`` when ``seq`` has a divisor
    under the row cap, else ``seq`` padded up to ``n_chunks`` equal pieces
    whenever the best divisor leaves chunks far over the row target."""
    n = pick_n_chunks(batch, seq)
    cap = max(1, (batch * seq) // _TARGET_ROWS)
    if cap >= 2 and n < cap and batch * (seq // n) > 2 * _TARGET_ROWS:
        n = min(cap, seq)
        chunk = -(-seq // n)  # ceil
        return n, n * chunk
    return n, seq


def _mm_f32(a: Tensor, b: Tensor) -> Tensor:
    """fp32 a @ b from compute-dtype operands: exact products, fp32
    accumulation (the reference's ``preferred_element_type=float32``). On
    the card a bf16 pair goes to cuBLAS with an fp32 output; elsewhere the
    operands are widened first, which computes the same function."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _FusedLinearCE(torch.autograd.Function):
    """Per-token cross entropy [B, T] of ``x @ w^T`` against ``labels``,
    in ``n_chunks`` sequence chunks (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, x, w, labels, n_chunks):
        b, t, d = x.shape
        c = t // n_chunks
        wc = w.to(x.dtype)
        losses = torch.empty(b, t, dtype=torch.float32, device=x.device)
        lse = torch.empty_like(losses)
        for i in range(n_chunks):
            sl = slice(i * c, (i + 1) * c)
            logits = _mm_f32(x[:, sl].reshape(-1, d), wc.t()).view(b, c, -1)
            m = logits.amax(dim=-1, keepdim=True)
            lse_c = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
            picked = logits.gather(-1, labels[:, sl, None])[..., 0]
            losses[:, sl] = lse_c - picked
            lse[:, sl] = lse_c
        ctx.save_for_backward(x, w, labels, lse)
        ctx.n_chunks = n_chunks
        return losses

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        b, t, d = x.shape
        c = t // ctx.n_chunks
        cdt = x.dtype
        wc = w.to(cdt)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = torch.empty_like(x)
        for i in range(ctx.n_chunks):
            sl = slice(i * c, (i + 1) * c)
            xc = x[:, sl].reshape(-1, d)
            logits = _mm_f32(xc, wc.t())  # recomputed, fp32
            p = torch.exp(logits - lse[:, sl].reshape(-1, 1))
            # softmax - onehot, in place of the [rows, V] one-hot
            p[torch.arange(p.shape[0], device=p.device), labels[:, sl].reshape(-1)] -= 1.0
            dl = (p * g[:, sl].reshape(-1, 1)).to(cdt)  # compute dtype into the products
            dx[:, sl] = (dl @ wc).view(b, c, d)
            dw += _mm_f32(dl.t(), xc)
        return dx, dw.to(w.dtype), None, None


def fused_linear_cross_entropy(x: Tensor, w: Tensor, labels: Tensor, n_chunks: int = 1) -> Tensor:
    """Per-token cross entropy [B, T] (fp32) of the fused head(x) vs labels.

    x: [B, T, D] activations in the compute dtype (the head casts w to
       x.dtype for its products, like ``TransformerLM``'s head)
    w: [V, D] (the tied embedding table, or the transpose of the untied head)
    labels: [B, T] integer; ``n_chunks`` must divide T (``pick_n_chunks``)
    Gradients flow to x and w."""
    if x.shape[1] % n_chunks:
        raise ValueError(f"n_chunks {n_chunks} does not divide T {x.shape[1]}")
    return _FusedLinearCE.apply(x, w, labels.long(), n_chunks)


def _padded_fused_ce(x: Tensor, w: Tensor, labels: Tensor) -> Tensor:
    """``fused_linear_cross_entropy`` behind ``chunk_plan``: pads T when it
    has no divisor under the row cap (pad rows carry label 0 and are sliced
    off, so they get a zero cotangent and the grads are exact)."""
    b, t = labels.shape
    n, tp = chunk_plan(b, t)
    if tp != t:
        x = F.pad(x, (0, 0, 0, tp - t))
        labels = F.pad(labels, (0, tp - t))
    losses = fused_linear_cross_entropy(x, w, labels, n)
    return losses[:, :t] if tp != t else losses


def model_token_losses(
    model, x: Tensor, y: Tensor, deterministic: bool = True,
    dropout_seed: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """(per-token next-token CE [B, T] through the fused head, the MoE
    layers' auxiliary loss): the one invocation of this path, shared by the
    training loss (``training/trainer.py::lm_loss``, which adds the
    auxiliary loss) and the eval loss (``evaluate.py::lm_eval_sums``, which
    leaves it out) so the two cannot drift."""
    feats, aux = model.features(x, deterministic=deterministic, dropout_seed=dropout_seed)
    w, w_is_vd = model.head_weight()
    return _padded_fused_ce(feats.to(model.cdt), w if w_is_vd else w.t(), y), aux


__all__ = [
    "fused_linear_cross_entropy", "pick_n_chunks", "chunk_plan", "fused_ce_ok",
    "model_token_losses",
]
