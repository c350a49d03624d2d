"""Config registry of the port: the dense family's qwen1.5-0.5b (tied
embeddings, int8 pool) and codeqwen1.5-7b (untied embeddings, int4 pool),
its local-attention members gemma3-12b (5 local layers of window 1024 to 1
global, GeGLU, hd 256) and h2o-danube-3-4b (every layer local, window
4096, hd 120), both int8 pools, and the MoE family's moonshot-v1-16b-a3b
(64 experts, top-6, two shared experts, int8 pool). The reference's other
architectures come with their families (ROADMAP queue 1, item 9)."""

from __future__ import annotations

import importlib

from .base import ModelConfig, MoEConfig, reduce_for_smoke  # noqa: F401

_MODULES = {
    "qwen1.5-0.5b": "qwen15_05b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "gemma3-12b": "gemma3_12b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
}
ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {', '.join(ARCHS)}); "
            "other families follow ROADMAP queue 1, item 9")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
