"""Model config (``ModelConfig``) and the smoke reduction, dense family.

The port's copy of ``repro/configs/base.py`` for the fields the dense
decoder path reads. Other families (MoE, recurrent, encoder-decoder,
vision) come with their slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.qplan import PLANS, QuantPlan


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    pattern: tuple = ("global",)   # per-layer block pattern
    qkv_bias: bool = False
    rope_theta: float = 1e4
    pos_embed: str = "rope"
    mlp: str = "swiglu"
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
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


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Same family, tiny dims — the dense-family part of the reference's
    ``reduce_for_smoke`` (identical widths, so the two stay comparable)."""
    n_layers = min(len(cfg.pattern) + (1 if cfg.n_remainder else 0), cfg.n_layers)
    kv = min(cfg.n_kv_heads, 2)
    heads = max(4, kv)
    return dataclasses.replace(
        cfg,
        n_layers=n_layers, d_model=64, n_heads=heads, n_kv_heads=kv,
        head_dim=16, d_ff=128, vocab_size=512,
        kv_cache_dtype="bfloat16",
    )
