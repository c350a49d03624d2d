"""Model config (``ModelConfig``, ``MoEConfig``) and the smoke reduction.

The port's copy of ``repro/configs/base.py`` for the fields the dense and
MoE decoder paths read, global and local (sliding-window) attention
layers included. Other families (recurrent, encoder-decoder, vision) come
with their slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.qplan import PLANS, QuantPlan


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    group_size: int = 128          # tokens per dispatch group (memory knob)
    router_dtype: str = "float32"  # router stays high precision (mixed prec.)
    n_shared: int = 0              # shared-expert multiplier (deepseek/llama4)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    pattern: tuple = ("global",)   # per-layer block pattern: "global" | "local"
    window: int = 4096             # local-attention window
    kv_repeat: int = 1             # kv heads replicated for the cacheless prefill
    qkv_bias: bool = False
    rope_theta: float = 1e4
    pos_embed: str = "rope"
    mlp: str = "swiglu"            # swiglu | geglu
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    moe_pattern: Optional[tuple] = None   # per-pattern-slot: MoE mlp? (None => all)
    # The reference defaults to a legacy single QuantPolicy (dequant-einsum
    # serving), which the port does not carry; its default is the bf16 plan.
    quant: QuantPlan = PLANS["bf16"]
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 | int4 (serve-time pool)
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_remainder(self) -> int:
        return self.n_layers % len(self.pattern)

    def layer_type(self, i: int) -> str:
        """Layer i's attention type ("global" or "local"): the pattern
        repeated over the superblocks, then its prefix for the remainder."""
        return self.pattern[i % len(self.pattern)]

    def layer_types(self) -> tuple:
        return tuple(self.layer_type(i) for i in range(self.n_layers))

    def moe_flags(self) -> tuple:
        """Per-layer MoE flag, aligned with the layers."""
        if self.moe is None:
            return (False,) * self.n_layers
        mp = self.moe_pattern or (True,) * len(self.pattern)
        reps = -(-self.n_layers // len(mp))
        return (mp * reps)[: self.n_layers]


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Same family, tiny dims — the dense and MoE parts of the reference's
    ``reduce_for_smoke`` (identical widths, so the two stay comparable)."""
    n_layers = min(len(cfg.pattern) + (1 if cfg.n_remainder else 0), cfg.n_layers)
    kv = min(cfg.n_kv_heads, 2)
    heads = max(4, kv)
    moe = None
    if cfg.moe:
        moe = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=64, group_size=16)
    return dataclasses.replace(
        cfg,
        n_layers=n_layers, d_model=64, n_heads=heads, n_kv_heads=kv,
        head_dim=16, d_ff=128, vocab_size=512, moe=moe,
        window=min(cfg.window, 16),
        kv_cache_dtype="bfloat16",
    )
