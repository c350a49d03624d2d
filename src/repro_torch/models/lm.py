"""Decoder-only LM assembly (dense family) for the port.

The port's counterpart of ``repro/models/lm.py``. Parameters are a plain
dict: the input embedding (V, D), ``tok_embed`` when the head is tied to
it or ``in_embed`` beside an untied ``lm_head`` {"w": (D, V)}, which every
plan keeps bf16 (``qplan.KEEP_BF16``); ``final_norm``; and ``layers``, a
list with one dict per layer (``ln1``, ``attn`` {wq, wk, wv, wo},
``ln2``, ``mlp`` {w_gate, w_up, w_down}); dense weights keep the
reference's (in, out) layout. The reference's ``lax.scan`` over stacked superblocks is a Python
loop over ``layers`` here. Serving caches are a list of per-layer pool
dicts (serving/cache.py), updated in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import qlinear
from repro_torch.device import resolve_device
from . import layers as L

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_supported(cfg) -> None:
    if cfg.family != "dense" or any(t != "global" for t in cfg.pattern):
        raise NotImplementedError(
            f"{cfg.name}: only the dense family with global attention is "
            "ported; other layer types follow ROADMAP queue 1, items 4 and 9")
    if cfg.pos_embed != "rope":
        raise NotImplementedError(f"{cfg.name}: learned positions are not "
                                  "ported yet")


def embed_table(params: dict) -> torch.Tensor:
    """The input embedding (V, D): ``tok_embed`` (tied) or ``in_embed``."""
    return params["tok_embed"] if "tok_embed" in params else params["in_embed"]


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters from ``generator`` (which must live on ``device``):
    the reference's distributions (normal * fan_in^-0.5 dense weights, zero
    biases, normal * 0.02 embeddings, unit norm scales), not its bits."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    D, H, KV, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

    def normal(*shape, std):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    def dense(din, dout, bias=False):
        p = {"w": normal(din, dout, std=din ** -0.5)}
        if bias:
            p["b"] = torch.zeros((dout,), dtype=dtype, device=dev)
        return p

    def norm():
        return {"scale": torch.ones((D,), dtype=dtype, device=dev)}

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": norm(),
            "attn": {"wq": dense(D, H * hd, cfg.qkv_bias),
                     "wk": dense(D, KV * hd, cfg.qkv_bias),
                     "wv": dense(D, KV * hd, cfg.qkv_bias),
                     "wo": dense(H * hd, D)},
            "ln2": norm(),
            "mlp": {"w_gate": dense(D, F), "w_up": dense(D, F),
                    "w_down": dense(F, D)},
        })
    embed = normal(cfg.vocab_size, D, std=0.02)
    if cfg.tie_embeddings:
        return {"tok_embed": embed, "final_norm": norm(), "layers": layers}
    return {"in_embed": embed, "final_norm": norm(), "layers": layers,
            "lm_head": {"w": normal(D, cfg.vocab_size, std=D ** -0.5)}}


def apply_layer(p: dict, x: torch.Tensor, *, cfg, cache: Optional[dict] = None,
                pos: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                kv_splits: int = 1, attn_backend: str = "auto") -> torch.Tensor:
    """One pre-norm decoder layer: x + attn(ln1(x)), then + mlp(ln2(.))."""
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    x = x + L.attn_apply(p["attn"], h, cfg=cfg, cache=cache, pos=pos,
                         block_tables=block_tables, kv_splits=kv_splits,
                         attn_backend=attn_backend)
    h2 = L.norm_apply(p["ln2"], x, cfg.norm)
    return x + L.mlp_apply(p["mlp"], h2, cfg=cfg)


def forward(params: dict, cfg, tokens: torch.Tensor, *,
            caches: Optional[list] = None, pos: Optional[torch.Tensor] = None,
            block_tables: Optional[torch.Tensor] = None, kv_splits: int = 1,
            attn_backend: str = "auto"):
    """Token ids (B, S) -> (final hidden states (B, S, D), caches).

    Without caches: a causal forward over the whole sequence. With paged
    caches and block tables (B, nb): S == 1 is a batched decode step, S > 1
    a chunk with per-row start positions ``pos`` (B,); the pools are
    updated in place and returned. ``kv_splits`` (> 1: split-KV decode)
    and ``attn_backend`` (the registry backend of the decode attention op)
    reach every layer's attention."""
    _check_supported(cfg)
    x = embed_table(params)[tokens].to(torch_dtype(cfg.dtype))
    for i, lp in enumerate(params["layers"]):
        x = apply_layer(lp, x, cfg=cfg,
                        cache=None if caches is None else caches[i],
                        pos=pos, block_tables=block_tables, kv_splits=kv_splits,
                        attn_backend=attn_backend)
    return L.norm_apply(params["final_norm"], x, cfg.norm), caches


def logits_fn(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) f32 logits against the tied embedding or the
    untied ``lm_head``: a plain f32 product outside any kernel, as the
    reference's einsum with an f32 accumulator."""
    if cfg.tie_embeddings:
        return torch.matmul(hidden.float(), params["tok_embed"].float().T)
    return torch.matmul(hidden.float(), params["lm_head"]["w"].float())


def quantize_tree(params: dict, cfg) -> dict:
    """Replace every plan-covered dense ``{"w": ...}`` with ``{"qw":
    QuantizedWeight}`` (the paper's offline pack step), per layer on the
    weights' device. Tags are path components ("layers.3.attn.wq"), matched
    by the plan's rules as in the reference."""
    plan = cfg.quant

    def walk(tree, path=""):
        if isinstance(tree, list):
            return [walk(v, f"{path}.{i}") for i, v in enumerate(tree)]
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            tag = f"{path}.{k}" if path else k
            lp = plan.policy_for(tag)
            if isinstance(v, dict) and "w" in v and v["w"].ndim == 2 and lp is not None:
                # When calibration is ported, keep the reference's rule
                # (lm.py:588-590 there): a static scale is stamped only on
                # lut_gemm leaves; bit-sliced leaves stay dynamic.
                if lp.a_scale == "static":
                    raise NotImplementedError(
                        "static activation scales need the calibration pass, "
                        "which is not ported yet (ROADMAP queue 1, item 2)")
                q = {"qw": qlinear.quantize_weight(v["w"], lp)}
                if "b" in v:
                    q["b"] = v["b"]
                out[k] = q
            else:
                out[k] = walk(v, tag)
        return out

    return walk(params)
