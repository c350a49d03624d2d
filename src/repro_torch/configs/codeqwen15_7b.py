"""codeqwen1.5-7b [dense]: qwen1.5-arch. 32L d_model=4096 32H (kv=32)
d_ff=13440 vocab=92416, untied embeddings, int4 KV pool
[hf:Qwen/CodeQwen1.5-7B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    pattern=("global",),
    qkv_bias=True,          # qwen1.5 QKV bias
    rope_theta=1_000_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    kv_cache_dtype="int4",
    source="hf:Qwen/CodeQwen1.5-7B; hf",
)
