"""h2o-danube-3-4b [dense]: llama+mistral mix, sliding-window attention.
24L d_model=3840 32H (kv=8) d_ff=10240 vocab=32000 [arXiv:2401.16818; unverified]
SWA on all layers (window 4096) -> bounded KV; head_dim 120; int8 KV pool."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,             # head_dim = 120
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    pattern=("local",),     # mistral-style SWA everywhere
    kv_repeat=2,
    window=4096,
    rope_theta=10_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    kv_cache_dtype="int8",
    source="arXiv:2401.16818; unverified",
)
