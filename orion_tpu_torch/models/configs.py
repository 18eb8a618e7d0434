"""Named model configs: the port's own copy of ``orion_tpu/models/configs.py``.

Same ``ModelConfig`` fields and defaults, same ``CONFIGS`` table, so a
config name or a ``--set`` override means the same model in both packages
(``tests/test_torch_package.py`` pins the field-for-field match).

``backend`` differs: it selects between a hand-written kernel and its plain
PyTorch version, and takes

- ``"auto"``  -- the kernel for CUDA tensors, the plain version for CPU ones;
- ``"torch"`` -- the plain version everywhere (the on-card reference);
- ``"cuda"``  -- the kernel, raising on CPU tensors.

``chunk`` sizes only the plain chunked form; the kernel's chunk is a
constant of the kernel (``csrc/causal_dot_norm.cu``). ``attn_block_q`` /
``attn_block_k`` size the JAX package's TPU flash tiles and are not read:
the flash kernels' tile is a constant of ``csrc/flash_attention*.cu``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BACKENDS = ("auto", "torch", "cuda")


def hybrid_pattern(n_layers: int, period: int = 4) -> Tuple[str, ...]:
    """swa,swa,...,linear repeating: every ``period``-th layer is global
    linear attention, the rest sliding-window softmax."""
    return tuple(
        "linear" if (i + 1) % period == 0 else "swa" for i in range(n_layers)
    )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    vocab_size: int = 32000
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // n_heads
    mlp_hidden: Optional[int] = None  # default 4*d_model (gelu) / 8/3 (swiglu)
    mlp: str = "swiglu"  # "swiglu" | "gelu"
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    layer_types: Optional[Tuple[str, ...]] = None  # default all "linear"
    window: int = 512  # swa window
    attn_block_q: int = 512
    attn_block_k: int = 512
    feature_map: str = "elu1"  # linear-attn phi
    max_seq_len: int = 2048
    tie_embeddings: bool = True
    dropout: float = 0.0
    # numerics / execution
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    backend: str = "auto"  # "auto" | "torch" | "cuda" (module docstring)
    chunk: Optional[int] = None  # plain chunked form's chunk (None = default)
    remat: bool = False
    remat_policy: str = "full"
    remat_skip: int = 0
    sequence_parallel: bool = False
    ring_striped: bool = False
    n_experts: int = 0
    moe_period: int = 2
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_dropless: bool = False
    moe_ep_buffer: float = 2.0
    moe_group_size: int = 512
    moe_aux_weight: float = 1e-2
    moe_zloss_weight: float = 1e-3
    # classifier-only
    n_classes: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_mlp_hidden(self) -> int:
        if self.mlp_hidden:
            return self.mlp_hidden
        if self.mlp == "swiglu":
            # 8/3 * d rounded up to a multiple of 128, as the JAX package
            # sizes it, so the parameter shapes of the two packages agree
            h = int(self.d_model * 8 / 3)
            return max(128, (h + 127) // 128 * 128)
        return 4 * self.d_model

    def moe_at(self, layer: int) -> bool:
        """Does block ``layer`` (0-based) carry a routed-expert MLP?"""
        return self.n_experts > 0 and (layer + 1) % self.moe_period == 0

    @property
    def resolved_layer_types(self) -> Tuple[str, ...]:
        lt = self.layer_types or ("linear",) * self.n_layers
        if len(lt) != self.n_layers:
            raise ValueError(f"layer_types {lt} != n_layers {self.n_layers}")
        for t in lt:
            if t not in ("linear", "softmax", "swa"):
                raise ValueError(f"unknown layer type {t!r}")
        return lt


TINY = ModelConfig(
    name="tiny",
    vocab_size=256,  # byte-level
    d_model=128,
    n_layers=2,
    n_heads=4,
    max_seq_len=512,
    dtype="float32",
    remat=False,
)

LM_1B3 = ModelConfig(
    name="lm_1b3",
    vocab_size=32000,
    d_model=2048,
    n_layers=24,
    n_heads=16,
    max_seq_len=2048,
    dtype="bfloat16",
    remat=True,
    remat_skip=4,
)

HYBRID_7B = ModelConfig(
    name="hybrid_7b",
    vocab_size=32000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    layer_types=hybrid_pattern(32, period=4),
    window=1024,
    max_seq_len=4096,
    dtype="bfloat16",
    remat=True,
)

HYBRID_1B3 = ModelConfig(
    name="hybrid_1b3",
    vocab_size=32000,
    d_model=2048,
    n_layers=24,
    n_heads=16,
    layer_types=hybrid_pattern(24, period=4),
    window=1024,
    max_seq_len=2048,
    dtype="bfloat16",
    remat=True,
    remat_skip=4,
)

MOE_1B3_8E = ModelConfig(
    name="moe_1b3_8e",
    vocab_size=32000,
    d_model=2048,
    n_layers=24,
    n_heads=16,
    max_seq_len=2048,
    dtype="bfloat16",
    remat=True,
    n_experts=8,
    moe_period=2,
    moe_top_k=1,
)

MOE_1B3_4E = dataclasses.replace(
    MOE_1B3_8E, name="moe_1b3_4e", n_experts=4, moe_period=4,
)

LRA_LISTOPS_LINEAR = ModelConfig(
    name="lra_listops_linear",
    vocab_size=32,
    d_model=128,
    n_layers=4,
    n_heads=4,
    max_seq_len=2048,
    layer_types=("linear",) * 4,
    n_classes=10,
    dtype="float32",
    mlp="gelu",
    norm="layernorm",
)

LRA_LISTOPS_SOFTMAX = dataclasses.replace(
    LRA_LISTOPS_LINEAR, name="lra_listops_softmax", layer_types=("softmax",) * 4
)

LRA_TEXT_LINEAR = ModelConfig(
    name="lra_text_linear",
    vocab_size=256,
    d_model=256,
    n_layers=4,
    n_heads=4,
    max_seq_len=4096,
    layer_types=("linear",) * 4,
    n_classes=2,
    dtype="float32",
    mlp="gelu",
    norm="layernorm",
)

LRA_TEXT_SOFTMAX = dataclasses.replace(
    LRA_TEXT_LINEAR, name="lra_text_softmax", layer_types=("softmax",) * 4
)

CONFIGS = {
    c.name: c
    for c in [
        TINY,
        LM_1B3,
        HYBRID_1B3,
        HYBRID_7B,
        MOE_1B3_8E,
        MOE_1B3_4E,
        LRA_LISTOPS_LINEAR,
        LRA_LISTOPS_SOFTMAX,
        LRA_TEXT_LINEAR,
        LRA_TEXT_SOFTMAX,
    ]
}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    cfg = CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = [
    "ModelConfig", "CONFIGS", "get_config", "hybrid_pattern", "BACKENDS",
    "TINY", "LM_1B3",
]
