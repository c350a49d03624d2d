"""Config registry of the port: the dense family's qwen1.5-0.5b (tied
embeddings, int8 pool) and codeqwen1.5-7b (untied embeddings, int4 pool),
its local-attention members gemma3-12b (5 local layers of window 1024 to 1
global, GeGLU, hd 256) and h2o-danube-3-4b (every layer local, window
4096, hd 120), both int8 pools, and the MoE family's moonshot-v1-16b-a3b
(64 experts, top-6, two shared experts, int8 pool), the hybrid family's
recurrentgemma-9b (12 superblocks of two RG-LRU layers and one local
multi-query attention layer, then two RG-LRU layers; int8 pool) and the
ssm family's rwkv6-1.6b (24 RWKV6 layers, no attention). ``deepgemm-cnn``
is the paper's CNN (``CNNConfig``; not one of the decoder LMs in
``ARCHS``). The reference's encoder-decoder and vision architectures come
with their families (ROADMAP queue 1, item 9)."""

from __future__ import annotations

import importlib

from .base import ModelConfig, MoEConfig, reduce_for_smoke  # noqa: F401

_MODULES = {
    "qwen1.5-0.5b": "qwen15_05b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "gemma3-12b": "gemma3_12b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-1.6b": "rwkv6_16b",
}
ARCHS = tuple(_MODULES)          # the decoder LMs
_MODULES["deepgemm-cnn"] = "deepgemm_cnn"


def get_config(name: str):
    """The config of ``name``: a ``ModelConfig``, or the CNN's
    ``CNNConfig``."""
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {', '.join(_MODULES)}); "
            "other families follow ROADMAP queue 1, item 9")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
