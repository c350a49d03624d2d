"""moonshot-v1-16b-a3b [moe]: kimi/moonlight-style, 64 experts top-6.
48L d_model=2048 16H (kv=16) d_ff=1408(expert) vocab=163840
[hf:moonshotai/Moonlight-16B-A3B; hf]
Assignment figures used verbatim; note 48L x 64e x 1408 gives ~27B total
params (the hf Moonlight uses 27L for its 16B) - see DESIGN.md 4.

The reference config's training-only fields (``microbatch=2``,
``remat="names"``) are left out: the port serves and does not train."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    pattern=("global",),
    rope_theta=50_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  capacity_factor=1.25, group_size=128, n_shared=2),
    kv_cache_dtype="int8",
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
