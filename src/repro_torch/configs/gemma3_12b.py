"""gemma3-12b [dense]: 5:1 local:global attention, 128k context.
48L d_model=3840 16H (kv=8) d_ff=15360 vocab=262144 [hf:google/gemma-3-1b-pt;
unverified]. head_dim=256 per the public gemma3 family configs. 40 of the
48 layers attend a 1024-row window; int8 KV pool. The reference's gemma3:
no qk-norm, no sandwich norms, no embedding scale, one rope_theta."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=("local",) * 5 + ("global",),
    kv_repeat=2,
    window=1024,
    rope_theta=1_000_000.0,
    mlp="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    kv_cache_dtype="int8",
    source="hf:google/gemma-3-1b-pt; unverified",
)
