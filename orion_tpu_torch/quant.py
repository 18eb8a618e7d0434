"""Int8 / int4 weight-streamed decode: the port's ``orion_tpu/quant.py``.

Decode at batch 4 is bound by the bytes of the weights it streams each step.
Weights are stored int8 with symmetric per-output-channel scales
(``q = round(w / s)``, ``s = max|w| / 127`` over the input axis), or, for the
dense layers in ``"int4"`` mode, as int4 with two nibbles packed in a byte
(``s = max|w| / 7``). The scale is applied to the product's output
(``y * s[out]``), which is exact for per-output-channel scales.

Layouts (what ``convert.py`` maps the JAX package's quantized tree onto):

- ``Int8Dense``: ``weight_q`` [out, in] int8 (the flax ``kernel_q`` [in, out],
  transposed, as every dense weight of the port) and ``weight_s`` [out] fp32;
- ``Int4Dense``: ``weight_p4`` [in/2, out] int8 -- the JAX package's
  ``kernel_p4`` layout as it is: packed row k holds input rows 2k (low
  nibble) and 2k + 1 (high nibble) of every output channel, so the kernel's
  threads walk neighbouring output channels with wide loads -- and
  ``weight_s`` [out] fp32;
- ``Int8Embed``: ``weight_q`` [V, D] int8, ``weight_s`` [V] fp32 (one scale
  per row: the tied head's output channel);
- a MoE layer's expert stacks ``experts_{gate,up,down}_q`` [E, in, out] int8
  with ``_s`` [E, out] fp32 (``models/moe.py``).

Quantized tensors are buffers, not parameters: a quantized model serves and
is not trained. ``Int4Dense`` takes the hand-written kernel
(``ops/kernels/q4_matmul.py``, ``csrc/q4_matmul.cu``) for at most
``Q4_MAX_ROWS`` rows of CUDA tensors (decode), the JAX package's gate, and
otherwise -- prefill's rows, and every CPU tensor -- the split half-dots form
in the compute dtype, a product the JAX package leaves to XLA and the port to
``torch.matmul``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from orion_tpu_torch.ops.dispatch import resolve
from orion_tpu_torch.ops.kernels import q4_matmul as q4
from orion_tpu_torch.ops.kernels.q4_matmul import unpack_nibbles

Tensor = torch.Tensor

Q4_MAX_ROWS = q4.MAX_ROWS  # rows up to which Int4Dense takes the kernel
MODES = ("", "int8", "int4")


def check_mode(quant: str) -> str:
    if quant not in MODES:
        raise ValueError(f"quant must be one of {MODES}, got {quant!r}")
    return quant


def quantize_int8(w: Tensor, reduce_axes) -> Tuple[Tensor, Tensor]:
    """Symmetric per-channel int8: (q int8, s fp32) with ``w ~ q * s`` (s
    broadcast over ``reduce_axes``); ``round`` is half to even."""
    reduce_axes = tuple(reduce_axes)
    w = w.float()
    amax = w.abs().amax(dim=reduce_axes, keepdim=True)
    s = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s.squeeze(reduce_axes)


def quantize_int4_packed(w: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric per-out-channel int4, two nibbles packed per byte along
    axis 0: w [in, out] -> (p int8 [in/2, out], s fp32 [out]); packed row k
    is ``(q[2k] & 0x0F) | (q[2k + 1] << 4)``."""
    if w.dim() != 2:
        raise ValueError(f"quantize_int4_packed takes a 2-D [in, out] kernel; got shape "
                         f"{tuple(w.shape)}")
    if w.shape[0] % 2:
        raise ValueError(f"quantize_int4_packed needs an even input dim (two nibbles share a "
                         f"byte along axis 0); got d_in={w.shape[0]}. Keep such layers int8.")
    w = w.float()
    s = w.abs().amax(0, keepdim=True).clamp_min(1e-12) / 7.0
    q = torch.clamp(torch.round(w / s), -7, 7).int()
    packed = (q[0::2] & 0x0F) | ((q[1::2] & 0x0F) << 4)  # 0..255, in int32
    p = torch.where(packed > 127, packed - 256, packed).to(torch.int8)
    return p, s.squeeze(0)


def _unpack_nibbles(p: Tensor, d_in: int) -> Tensor:
    """[in/2, out] packed int8 -> [in, out] int8 (rows interleaved: the low
    nibble of packed row k is input row 2k)."""
    lo, hi = unpack_nibbles(p)
    return torch.stack([lo, hi], 1).reshape(d_in, p.shape[-1]).to(torch.int8)


def q4_split(x2: Tensor, p: Tensor, s: Tensor, cdt: torch.dtype) -> Tensor:
    """x2 [N, in] @ unpack(p) * s in the compute dtype, as the JAX package's
    split half-dots: even input columns against the low nibbles, odd against
    the high ones, the scale applied to the fp32 sum, rounded to ``cdt``."""
    lo, hi = unpack_nibbles(p)
    xc = x2.to(cdt)
    y = xc[:, 0::2] @ lo.to(cdt) + xc[:, 1::2] @ hi.to(cdt)
    return (y.float() * s).to(cdt)


class Int8Dense(nn.Module):
    """Bias-free dense layer with an int8 weight and per-out-channel fp32
    scales, the scale applied after the product (``Dense``'s drop-in)."""

    def __init__(self, d_in: int, d_out: int, cdt: torch.dtype, device=None):
        super().__init__()
        self.cdt = cdt
        self.register_buffer("weight_q", torch.zeros(d_out, d_in, dtype=torch.int8, device=device))
        self.register_buffer("weight_s", torch.ones(d_out, device=device))

    def forward(self, x: Tensor) -> Tensor:
        y = F.linear(x.to(self.cdt), self.weight_q.to(self.cdt))
        return (y.float() * self.weight_s).to(self.cdt)


class Int4Dense(nn.Module):
    """Bias-free dense layer with a nibble-packed int4 weight [in/2, out] and
    per-out-channel fp32 scales. At most ``Q4_MAX_ROWS`` rows on the kernel
    backend take ``q4_matmul_cuda``; everything else the split form."""

    def __init__(self, d_in: int, d_out: int, cdt: torch.dtype, backend: str = "auto",
                 device=None):
        super().__init__()
        if d_in % 2:
            raise ValueError(f"Int4Dense needs an even input dim (nibble packing); got "
                             f"d_in={d_in} -- keep this layer Int8Dense instead")
        self.cdt = cdt
        self.backend = backend
        self.register_buffer("weight_p4",
                             torch.zeros(d_in // 2, d_out, dtype=torch.int8, device=device))
        self.register_buffer("weight_s", torch.ones(d_out, device=device))

    def forward(self, x: Tensor) -> Tensor:
        lead, d_in = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, d_in).to(self.cdt)
        if x2.shape[0] <= Q4_MAX_ROWS and resolve(self.backend, x2.device) == "cuda":
            y = q4.q4_matmul_cuda(x2.contiguous(), self.weight_p4, self.weight_s)
        else:
            y = q4_split(x2, self.weight_p4, self.weight_s, self.cdt)
        return y.reshape(*lead, -1)


class Int8Embed(nn.Module):
    """An embedding table stored int8 with one fp32 scale per row: the token
    lookup (rows times their scale, fp32) and the tied head (``attend``)."""

    def __init__(self, rows: int, d: int, device=None):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(rows, d, dtype=torch.int8, device=device))
        self.register_buffer("weight_s", torch.ones(rows, device=device))

    def forward(self, ids) -> Tensor:
        return self.weight_q[ids].float() * self.weight_s[ids][..., None]

    def attend(self, x: Tensor, cdt: torch.dtype) -> Tensor:
        """Tied head: x [..., D] -> fp32 logits [..., V]: compute-dtype
        operands (an int8 value is exact in bf16), fp32 products and sums,
        the row scale after."""
        return (x.to(cdt).float() @ self.weight_q.float().t()) * self.weight_s


# Reduce axes (the input / contraction dims, in the port's layout) by a
# quantized tensor's name; the surviving axes are the output channels, whose
# scale commutes out of the product.
_REDUCE_AXES = {
    "weight_q": (1,),  # a dense weight [out, in] -> s[out]; an embedding [V, D] -> s[V]
    "weight_p4": (0,),  # packed int4 [in/2, out], from the weight's transpose -> s[out]
    "lm_head_kernel_q": (0,),  # the untied head [D, V] -> s[V]
    "experts_gate_q": (1,),  # [E, in, out] -> s[E, out]
    "experts_up_q": (1,),
    "experts_down_q": (1,),
}


@torch.no_grad()
def quantize_params_for_decode(qmodel: nn.Module, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The fp32 (or compute-dtype) state_dict of a full-precision model ->
    the state_dict of ``qmodel``, its quantized counterpart: every tensor
    ``qmodel`` holds as ``*_q`` / ``*_p4`` is quantized from the tensor of the
    same name without the suffix, its ``*_s`` made beside it; everything else
    (norms, the positional table, routers) is copied. Driven by ``qmodel``'s
    own state_dict, so the rules follow what its modules hold."""
    out: Dict[str, Tensor] = {}
    for key, leaf in qmodel.state_dict().items():
        name = key.rsplit(".", 1)[-1]
        if name.endswith("_s"):
            continue  # made with its _q / _p4 twin
        if name.endswith("_p4"):
            src = key[: -len("_p4")]
            q, s = quantize_int4_packed(params[src].t())
        elif name.endswith("_q"):
            src = key[: -len("_q")]
            q, s = quantize_int8(params[src], _REDUCE_AXES[name])
        else:
            out[key] = params[key]
            continue
        if q.shape != leaf.shape or q.dtype != leaf.dtype:
            raise ValueError(f"{key}: quantized {tuple(q.shape)} {q.dtype}, the model holds "
                             f"{tuple(leaf.shape)} {leaf.dtype}")
        out[key], out[src + "_s"] = q, s
    missing = set(qmodel.state_dict()) - set(out)
    if missing:
        raise KeyError(f"no source for {sorted(missing)}")
    return out


__all__ = [
    "Int8Dense", "Int4Dense", "Int8Embed", "quantize_int8", "quantize_int4_packed",
    "quantize_params_for_decode", "unpack_nibbles", "q4_split", "check_mode", "MODES",
    "Q4_MAX_ROWS",
]
