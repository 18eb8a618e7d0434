"""Weights from the JAX package's ``TransformerLM`` and ``LRAClassifier``
into the port's.

The input is the flax parameter tree as nested dicts of numpy arrays (what
``jax.device_get(model.init(...))`` or a restored checkpoint gives), with or
without its top ``"params"`` level. Nothing here imports JAX.

Mapping (flax path -> torch state_dict key):

- ``embed/embedding``, ``pos_embed/embedding`` -> ``embed.weight``,
  ``pos_embed.weight``; a tied head stays tied to ``embed``, an untied one
  is ``lm_head_kernel`` [D, V] as it is;
- ``block_{i}/norm1/scale``, ``norm2/scale``, ``final_norm/scale`` -> the
  norms' ``weight``, and under LayerNorm their ``bias`` -> ``bias``;
- every ``Dense`` ``kernel`` [in, out] -> ``Linear``-style ``weight``
  [out, in], transposed: ``block_{i}/attn/{wq,wk,wv,wo}``,
  ``block_{i}/mlp/{gate,up,down}`` and the ``learnable`` feature map's
  ``block_{i}/attn/phi_proj``;
- the ``favor`` feature map's ``block_{i}/attn/favor_proj`` [Dh, Dh] as it
  is;
- the classifier's (``classifier=True``): ``cls`` [D] as it is, and its
  head, ``head/kernel`` [D, C] -> ``head.weight`` [C, D] transposed,
  ``head/bias`` -> ``head.bias``;
- in a MoE block (``cfg.moe_at(i)``): ``block_{i}/mlp/router/kernel`` [d, E]
  -> ``blocks.{i}.mlp.router`` [E, d], transposed, and the expert stacks
  ``block_{i}/mlp/experts_{gate,up,down}`` as they are.

A quantized tree (``quant="int8"`` / ``"int4"``: the tree the JAX
package's ``quantize_params_for_decode`` returns) maps onto the port's
quantized model (``orion_tpu_torch/quant.py``), its int8 tensors kept int8:

- ``embed/embedding_q`` [V, D], ``embedding_s`` [V] -> ``embed.weight_q``,
  ``embed.weight_s`` as they are, and so ``lm_head_kernel_q`` [D, V] and
  ``lm_head_kernel_s`` [V] (the untied head, int8 in both modes);
- a dense layer's ``kernel_q`` [in, out] -> ``weight_q`` [out, in],
  transposed as every dense weight; ``kernel_p4`` [in/2, out] (int4) ->
  ``weight_p4`` in the same layout: the kernel (``csrc/q4_matmul.cu``) reads
  it so, each packed row's bytes of neighbouring output channels together;
  ``kernel_s`` [out] -> ``weight_s``;
- ``block_{i}/mlp/experts_{gate,up,down}_q`` [E, in, out] and ``_s`` [E,
  out] as they are;
- ``phi_proj`` stays full precision, as in the JAX package.

A JAX pipeline-layout tree (the JAX Trainer's state at pp > 1:
``blocks_stacked`` holding the blocks' leaves stacked by group) is first
unstacked into ``block_{i}`` (``parallel/pipeline_lm.py``'s
``unstack_lm_params``, the counterpart of the JAX package's
``unstack_if_pipeline``), so it maps as a pp=1 tree.

A missing or unexpected key, or a shape that disagrees with ``cfg``, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from orion_tpu_torch.models.classifier import LRAClassifier
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.models.transformer import check_supported
from orion_tpu_torch.quant import check_mode


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _quantized(spec: Dict[str, tuple], quant: str) -> Dict[str, tuple]:
    """The full-precision spec -> the quantized tree's: each dense kernel as
    ``kernel_q`` (or ``kernel_p4``) + ``kernel_s``, the embedding table and
    the expert stacks as ``_q`` + ``_s``."""
    out = {}
    for path, (key, shape, transpose) in spec.items():
        base = key[: -len(".weight")] if key.endswith(".weight") else key
        if path == "embed/embedding":
            out["embed/embedding_q"] = ("embed.weight_q", shape, False)
            out["embed/embedding_s"] = ("embed.weight_s", shape[:1], False)
        elif path == "lm_head_kernel":  # [D, V]
            out["lm_head_kernel_q"] = ("lm_head_kernel_q", shape, False)
            out["lm_head_kernel_s"] = ("lm_head_kernel_s", shape[1:], False)
        elif transpose and not path.endswith(("router/kernel", "phi_proj/kernel")):
            # a dense layer [out, in]
            d_out, d_in = shape
            prefix = path[: -len("kernel")]
            if quant == "int4":
                out[prefix + "kernel_p4"] = (base + ".weight_p4", (d_in // 2, d_out), False)
            else:
                out[prefix + "kernel_q"] = (base + ".weight_q", shape, True)
            out[prefix + "kernel_s"] = (base + ".weight_s", (d_out,), False)
        elif len(shape) == 3:  # an expert stack [E, in, out]
            out[path + "_q"] = (key + "_q", shape, False)
            out[path + "_s"] = (key + "_s", (shape[0], shape[2]), False)
        else:
            out[path] = (key, shape, transpose)
    return out


def expected_params(cfg: ModelConfig, quant: str = "", classifier: bool = False
                    ) -> Dict[str, tuple]:
    """flax path -> (torch key, torch shape, transpose?) for ``cfg``'s LM
    (and the quantized tree of ``quant``; its ``_q`` / ``_p4`` leaves are
    int8), or with ``classifier`` for its ``LRAClassifier``."""
    check_supported(cfg)
    check_mode(quant)
    if classifier and quant:
        raise ValueError("the classifier has no quantized form")
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hd, hid = cfg.n_heads * dh, cfg.resolved_mlp_hidden
    norms = {"scale": "weight", **({"bias": "bias"} if cfg.norm == "layernorm" else {})}
    spec = {
        "embed/embedding": ("embed.weight", (cfg.vocab_size, d), False),
        "pos_embed/embedding": ("pos_embed.weight", (cfg.max_seq_len, d), False),
    }
    for leaf, attr in norms.items():
        spec[f"final_norm/{leaf}"] = (f"final_norm.{attr}", (d,), False)
    if classifier:
        spec["cls"] = ("cls", (d,), False)
        spec["head/kernel"] = ("head.weight", (cfg.n_classes, d), True)
        spec["head/bias"] = ("head.bias", (cfg.n_classes,), False)
    elif not cfg.tie_embeddings:
        spec["lm_head_kernel"] = ("lm_head_kernel", (d, cfg.vocab_size), False)
    attn = {"attn/wq": (hd, d), "attn/wk": (hd, d), "attn/wv": (hd, d), "attn/wo": (d, hd)}
    mlp = {"mlp/up": (hid, d), "mlp/down": (d, hid)}
    e = cfg.n_experts
    experts = {"experts_up": (e, d, hid), "experts_down": (e, hid, d)}
    if cfg.mlp == "swiglu":
        mlp["mlp/gate"] = (hid, d)
        experts["experts_gate"] = (e, d, hid)
    for i, kind in enumerate(cfg.resolved_layer_types):
        for norm in ("norm1", "norm2"):
            for leaf, attr in norms.items():
                spec[f"block_{i}/{norm}/{leaf}"] = (f"blocks.{i}.{norm}.{attr}", (d,), False)
        if kind == "linear" and cfg.feature_map == "learnable":
            spec[f"block_{i}/attn/phi_proj/kernel"] = (
                f"blocks.{i}.attn.phi_proj.weight", (dh, dh), True)
        elif kind == "linear" and cfg.feature_map == "favor":
            spec[f"block_{i}/attn/favor_proj"] = (f"blocks.{i}.attn.favor_proj", (dh, dh), False)
        moe = cfg.moe_at(i)
        for path, shape in {**attn, **({} if moe else mlp)}.items():
            key = f"blocks.{i}.{path.replace('/', '.')}.weight"
            spec[f"block_{i}/{path}/kernel"] = (key, shape, True)
        if moe:
            spec[f"block_{i}/mlp/router/kernel"] = (f"blocks.{i}.mlp.router", (e, d), True)
            for name, shape in experts.items():
                spec[f"block_{i}/mlp/{name}"] = (f"blocks.{i}.mlp.{name}", shape, False)
    return _quantized(spec, quant) if quant else spec


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    quant: str = "", classifier: bool = False) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> the port's state_dict (CPU): fp32,
    and int8 for a quantized tree's ``_q`` / ``_p4`` leaves; ``classifier``:
    an ``LRAClassifier``'s tree."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    if "blocks_stacked" in tree:
        from orion_tpu_torch.parallel.pipeline_lm import unstack_lm_params

        tree = unstack_lm_params(tree, cfg)
    flat = _flatten(tree)
    spec = expected_params(cfg, quant, classifier)
    missing = sorted(set(spec) - set(flat))
    unexpected = sorted(set(flat) - set(spec))
    if missing or unexpected:
        raise KeyError(f"param tree mismatch: missing {missing}, unexpected {unexpected}")
    state = {}
    for path, (key, shape, transpose) in spec.items():
        int8 = path.endswith(("_q", "_p4"))
        arr = np.asarray(flat[path], dtype=np.int8 if int8 else np.float32)
        if transpose:
            arr = arr.T  # 2-D kernels only: the expert stacks keep their layout
        if arr.shape != shape:
            raise ValueError(f"{path}: shape {arr.shape} (torch layout), want {shape}")
        state[key] = torch.tensor(arr)  # a copy: device_get arrays are read-only
    return state


def load_jax_params(model: torch.nn.Module, tree: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a flax param tree into ``model`` (a ``TransformerLM`` or an
    ``LRAClassifier``) in place (strict; a quantized model takes the
    quantized tree of its mode); returns it."""
    classifier = isinstance(model, LRAClassifier)
    quant = "" if classifier else model.quant
    model.load_state_dict(params_from_jax(tree, model.cfg, quant, classifier), strict=True)
    return model


__all__ = ["params_from_jax", "load_jax_params", "expected_params"]
