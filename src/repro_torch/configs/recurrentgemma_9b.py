"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 2:1 recurrent:attn.
38L d_model=4096 16H (kv=1, MQA) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified]
38 = 12 x (rec, rec, local) + 2 trailing recurrent layers.
The local layers are multi-query: 16 query heads over one KV head of hd 256
(G 16 in the decode attention kernels); int8 KV pool. The reference's
training fields (microbatch, remat) are not carried."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=("recurrent", "recurrent", "local"),
    kv_repeat=16,
    window=2048,
    rope_theta=10_000.0,
    mlp="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    d_rnn=4096,
    conv_width=4,
    kv_cache_dtype="int8",
    source="arXiv:2402.19427; unverified",
)
