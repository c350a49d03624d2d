"""Prefill and decode steps of the fixed-batch serve loop.

The port's counterpart of ``make_prefill_step`` and ``make_decode_step``
in ``repro/launch/steps.py``, with the same names and call shapes. The
reference returns functions for ``jax.jit``; these are plain functions
that run eagerly under ``torch.inference_mode`` and update the dense slot
caches in place (the reference donates and returns new buffers).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import lm


def make_prefill_step(cfg, *, max_len: Optional[int] = None):
    """(params, batch{tokens (B, P)}) -> (last-position logits (B, 1, V),
    decode-ready caches of ``max_len`` rows, P unless given). The prompt
    attends over its raw K/V; the caches take them padded and, for an
    int8/int4 cache, quantized."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        h, kv = lm.forward(params, cfg, tokens, collect_cache=True)
        logits = lm.logits_fn(params, cfg, h[:, -1:])
        P = tokens.shape[1]
        return logits, lm.prefill_to_cache(cfg, kv, P, max_len or P)

    return prefill_step


def make_decode_step(cfg, *, attn_backend: str = "auto"):
    """(params, caches, batch{tokens (B, 1), pos (B,)}) -> (logits (B, 1,
    V), caches). ``attn_backend`` is the registry backend of the decode
    attention op ("ref": its plain version on any device)."""

    @torch.inference_mode()
    def decode_step(params, caches, batch):
        h, caches = lm.forward(params, cfg, batch["tokens"], caches=caches,
                               pos=batch["pos"], attn_backend=attn_backend)
        return lm.logits_fn(params, cfg, h), caches

    return decode_step
