"""rwkv6-1.6b [ssm]: Finch - attention-free, data-dependent decay WKV.
24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892; unverified]
No attention: each layer carries an O(1) matrix-valued WKV state. The
reference's training field (microbatch) is not carried."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # wkv heads = d_model / rwkv_head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    pattern=("rwkv",),
    mlp="gelu",            # channel-mix is 2-matrix (k,v) + receptance
    norm="layernorm",
    tie_embeddings=False,
    rwkv_head_size=64,
    source="arXiv:2404.05892; unverified",
)
