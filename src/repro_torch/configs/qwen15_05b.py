"""qwen1.5-0.5b [dense]: QKV bias. 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936 [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    pattern=("global",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    kv_cache_dtype="int8",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
