"""Decoder-only LM assembly (dense and MoE families) for the port.

The port's counterpart of ``repro/models/lm.py``. Parameters are a plain
dict: the input embedding (V, D), ``tok_embed`` when the head is tied to
it or ``in_embed`` beside an untied ``lm_head`` {"w": (D, V)}, which every
plan keeps bf16 (``qplan.KEEP_BF16``); ``final_norm``; and ``layers``, a
list with one dict per layer (``ln1``, ``attn`` {wq, wk, wv, wo},
``ln2``, and ``mlp`` {w_gate, w_up, w_down} or, on the layers
``cfg.moe_flags()`` marks, ``moe`` {w_router (D, E) f32, we_gate/we_up
(E, D, F), we_down (E, F, D), shared {w_gate, w_up, w_down}}); weights
keep the reference's (in, out) layout. The reference's ``lax.scan`` over
stacked superblocks is a Python loop over ``layers`` here.

Caches are a flat list with one dict per layer, in ``layers`` order,
updated in place: the paged engine's block pools (serving/cache.py), or
the fixed-batch loop's dense slot caches (``init_cache``,
``prefill_to_cache``), one (B, S) slot per sequence; a local layer's slot
is a ring of S = min(max_len, window) rows. Both lay a layer out as
``_layer_cache`` does: k/v codes with f32 scales for an int8 or int4
cache, k/v in the model dtype otherwise.

Each layer's attention type ("global" or "local", ``cfg.layer_types()``)
comes from the config's pattern, as the reference's superblocks give it;
a local layer attends over the last ``cfg.window`` rows
(``layers.attn_apply``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import qlinear
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import TP_ROLES
from . import layers as L

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_supported(cfg) -> None:
    if cfg.family not in ("dense", "moe") or any(t not in ("global", "local")
                                                 for t in cfg.pattern):
        raise NotImplementedError(
            f"{cfg.name}: only the dense and MoE families with global and "
            "local attention are ported; other layer types follow ROADMAP "
            "queue 1, item 9")
    if cfg.pos_embed != "rope":
        raise NotImplementedError(f"{cfg.name}: learned positions are not "
                                  "ported yet")


def embed_table(params: dict) -> torch.Tensor:
    """The input embedding (V, D): ``tok_embed`` (tied) or ``in_embed``."""
    return params["tok_embed"] if "tok_embed" in params else params["in_embed"]


def init_params(cfg, generator: torch.Generator, device="cuda", *,
                pack: bool = False, tp: int = 1, rank: int = 0) -> dict:
    """Random parameters from ``generator`` (which must live on ``device``):
    the reference's distributions (normal * fan_in^-0.5 dense and expert
    weights, an f32 router, zero biases, normal * 0.02 embeddings, unit
    norm scales), not its bits. Layers are MoE where ``cfg.moe_flags()``
    says so. With ``pack`` each layer goes through the plan's packer right
    after it is drawn, so the dense tree of a full-width model never exists
    at once (moonshot-v1-16b-a3b's bf16 experts alone are ~53 GB); the
    generator is drawn in the same order, so the result equals
    ``quantize_tree(init_params(...), cfg)``. With ``tp`` > 1 every rank
    draws the same full weights, packs each layer for ``tp`` ranks and
    keeps only rank ``rank``'s slice of it (``shard_tree``)."""
    _check_supported(cfg)
    if tp > 1 and not pack:
        raise ValueError("init_params: tp > 1 slices packed leaves; pass "
                         "pack=True")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    D, H, KV, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

    def normal(*shape, std, dt=dtype):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std).to(dt)

    def dense(din, dout, bias=False):
        p = {"w": normal(din, dout, std=din ** -0.5)}
        if bias:
            p["b"] = torch.zeros((dout,), dtype=dtype, device=dev)
        return p

    def norm():
        return {"scale": torch.ones((D,), dtype=dtype, device=dev)}

    def mlp(d_ff):
        return {"w_gate": dense(D, d_ff), "w_up": dense(D, d_ff),
                "w_down": dense(d_ff, D)}

    def moe():
        m = cfg.moe
        E, Fe = m.n_experts, m.d_ff_expert
        p = {"w_router": normal(D, E, std=D ** -0.5, dt=torch.float32),
             "we_gate": normal(E, D, Fe, std=D ** -0.5),
             "we_up": normal(E, D, Fe, std=D ** -0.5),
             "we_down": normal(E, Fe, D, std=Fe ** -0.5)}
        if m.n_shared:
            p["shared"] = mlp(m.n_shared * Fe)
        return p

    layers = []
    for i, is_moe in enumerate(cfg.moe_flags()):
        lp = {"ln1": norm(),
              "attn": {"wq": dense(D, H * hd, cfg.qkv_bias),
                       "wk": dense(D, KV * hd, cfg.qkv_bias),
                       "wv": dense(D, KV * hd, cfg.qkv_bias),
                       "wo": dense(H * hd, D)},
              "ln2": norm()}
        if is_moe:
            lp["moe"] = moe()
        else:
            lp["mlp"] = mlp(F)
        if pack:
            lp = shard_tree(quantize_tree(lp, cfg, f"layers.{i}", tp=tp), rank, tp)
        layers.append(lp)
    embed = normal(cfg.vocab_size, D, std=0.02)
    if cfg.tie_embeddings:
        top = {"tok_embed": embed, "final_norm": norm()}
    else:
        top = {"in_embed": embed, "final_norm": norm(),
               "lm_head": {"w": normal(D, cfg.vocab_size, std=D ** -0.5)}}
    if pack:
        top = shard_tree(quantize_tree(top, cfg, tp=tp), rank, tp)
    return {**top, "layers": layers}


def _layer_cache(cfg, rows: int, cols: int, dtype, device) -> dict:
    """One attention layer's cache, zeroed: (rows, cols, KV, ...) tensors (a
    dense slot cache is (B, S, ...), a paged pool (n_blocks, block_size,
    ...)). int8: k/v int8 (.., KV, hd) and k_sc/v_sc f32 (..,
    KV); int4: k/v uint8 (.., KV, hd/2), two codes a byte, low nibble
    first, and the same scales; bfloat16: k/v in ``dtype``."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    shape = (rows, cols, KV)
    packed = {"int8": (torch.int8, hd), "int4": (torch.uint8, hd // 2)}
    if cfg.kv_cache_dtype in packed:
        code_dtype, width = packed[cfg.kv_cache_dtype]
        return {"k": torch.zeros(shape + (width,), dtype=code_dtype, device=device),
                "v": torch.zeros(shape + (width,), dtype=code_dtype, device=device),
                "k_sc": torch.zeros(shape, dtype=torch.float32, device=device),
                "v_sc": torch.zeros(shape, dtype=torch.float32, device=device)}
    if cfg.kv_cache_dtype != "bfloat16":
        raise NotImplementedError(f"kv_cache_dtype {cfg.kv_cache_dtype!r} is "
                                  "not ported yet")
    return {"k": torch.zeros(shape + (hd,), dtype=dtype, device=device),
            "v": torch.zeros(shape + (hd,), dtype=dtype, device=device)}


def slot_rows(cfg, layer_type: str, max_len: int) -> int:
    """Rows of a layer's dense slot cache: ``max_len``, or on a local layer
    its ring of min(max_len, window) rows (reference lm.py:138)."""
    return min(max_len, cfg.window) if layer_type == "local" else max_len


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> list:
    """The fixed-batch loop's decode cache, zeroed: one dense slot cache per
    sequence for every layer, of ``slot_rows`` rows (a local layer's ring);
    an unquantized cache holds the model dtype."""
    _check_supported(cfg)
    return [_layer_cache(cfg, batch, slot_rows(cfg, t, max_len),
                         torch_dtype(cfg.dtype), resolve_device(device))
            for t in cfg.layer_types()]


def _fold(kv: torch.Tensor, W: int) -> torch.Tensor:
    """A local layer's prefill K/V (B, S, ...) folded into a ring of W rows:
    the last min(S, W) rows, zero-padded to W, rolled so that row t sits at
    slot t % W (reference lm.py:424-438)."""
    S = kv.shape[1]
    n = min(S, W)
    last = torch.nn.functional.pad(kv[:, S - n:], (0, 0) * (kv.ndim - 2) + (0, W - n))
    return torch.roll(last, (S - n) % W, dims=1)


def prefill_to_cache(cfg, prefill_caches: list, prefill_len: int,
                     max_len: int) -> list:
    """``forward(..., collect_cache=True)``'s per-layer K/V (B, P, KV, hd),
    post-RoPE and unquantized, -> decode buffers: a global layer's
    zero-padded to ``max_len`` rows, a local layer's folded into its ring of
    W = min(max_len, window) rows (slot t % W); then, for an int8 or int4
    cache, quantized through ``layers.KV_QUANT`` (a zero row gets scale
    1e-8 and code 0, as in the reference)."""
    out = []
    for i, kv in enumerate(prefill_caches):
        layer_type = cfg.layer_type(i)
        if kv["k"].shape[1] != prefill_len:
            raise ValueError(f"prefill K/V hold {kv['k'].shape[1]} rows, "
                             f"expected {prefill_len}")
        if layer_type == "local":
            W = slot_rows(cfg, layer_type, max_len)
            padded = {name: _fold(kv[name], W) for name in ("k", "v")}
        else:
            padded = {name: torch.nn.functional.pad(
                kv[name], (0, 0, 0, 0, 0, max_len - prefill_len)) for name in ("k", "v")}
        if cfg.kv_cache_dtype in L.KV_QUANT:
            qf = L.KV_QUANT[cfg.kv_cache_dtype][0]
            k, k_sc = qf(padded["k"])
            v, v_sc = qf(padded["v"])
            padded = {"k": k, "v": v, "k_sc": k_sc, "v_sc": v_sc}
        out.append(padded)
    return out


def apply_layer(p: dict, x: torch.Tensor, *, cfg, layer_type: str = "global",
                cache: Optional[dict] = None,
                pos: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                ring_tables: Optional[torch.Tensor] = None,
                ring_abs: Optional[torch.Tensor] = None,
                kv_splits: int = 1, attn_backend: str = "auto",
                collect: Optional[list] = None) -> torch.Tensor:
    """One pre-norm decoder layer: x + attn(ln1(x)), then + mlp(ln2(.)) or
    + moe(ln2(.)). ``collect`` receives the layer's K/V (see
    ``layers.attn_apply``)."""
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    x = x + L.attn_apply(p["attn"], h, cfg=cfg, layer_type=layer_type,
                         cache=cache, pos=pos,
                         block_tables=block_tables, ring_tables=ring_tables,
                         ring_abs=ring_abs, kv_splits=kv_splits,
                         attn_backend=attn_backend, collect=collect)
    h2 = L.norm_apply(p["ln2"], x, cfg.norm)
    if "moe" in p:
        return x + L.moe_apply(p["moe"], h2, cfg=cfg)
    return x + L.mlp_apply(p["mlp"], h2, cfg=cfg)


def forward(params: dict, cfg, tokens: torch.Tensor, *,
            caches: Optional[list] = None, pos: Optional[torch.Tensor] = None,
            block_tables: Optional[torch.Tensor] = None,
            ring_tables: Optional[torch.Tensor] = None,
            ring_abs: Optional[torch.Tensor] = None, kv_splits=1,
            attn_backend: str = "auto", collect_cache: bool = False):
    """Token ids (B, S) -> (final hidden states (B, S, D), caches).

    Without caches: a causal forward over the whole sequence; with
    ``collect_cache`` the returned caches are each layer's post-RoPE,
    unquantized K/V ({"k", "v"}, (B, S, KV, hd)) for ``prefill_to_cache``,
    else None. With paged caches and block tables (B, nb): S == 1 is a
    batched decode step, S > 1 a chunk with per-row start positions
    ``pos`` (B,). With dense slot caches and no tables: a one-token decode
    step at positions ``pos`` (B,). Caches are updated in place and
    returned. ``kv_splits`` (> 1: split-KV decode over the paged pool; an
    int for every layer, or a sequence with one per layer) and
    ``attn_backend`` (the registry backend of the decode attention op)
    reach every layer's attention; each layer attends as its type in
    ``cfg.layer_types()`` says. ``ring_tables`` (B, ring_len) ring-page
    the local layers (their pools are the engine's ring pool, the
    reference's lm.py:185-239); a one-token step also takes ``ring_abs``
    (B, nb), the same rings as absolute tables (``layers.attn_apply``)."""
    _check_supported(cfg)
    collected = [] if collect_cache and caches is None else None
    n = len(params["layers"])
    splits = [kv_splits] * n if isinstance(kv_splits, int) else list(kv_splits)
    x = embed_table(params)[tokens].to(torch_dtype(cfg.dtype))
    for i, lp in enumerate(params["layers"]):
        x = apply_layer(lp, x, cfg=cfg, layer_type=cfg.layer_type(i),
                        cache=None if caches is None else caches[i],
                        pos=pos, block_tables=block_tables,
                        ring_tables=ring_tables, ring_abs=ring_abs,
                        kv_splits=splits[i], attn_backend=attn_backend,
                        collect=collected)
    h = L.norm_apply(params["final_norm"], x, cfg.norm)
    return h, caches if collected is None else collected


def logits_fn(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) f32 logits against the tied embedding or the
    untied ``lm_head``: a plain f32 product outside any kernel, as the
    reference's einsum with an f32 accumulator."""
    if cfg.tie_embeddings:
        return torch.matmul(hidden.float(), params["tok_embed"].float().T)
    return torch.matmul(hidden.float(), params["lm_head"]["w"].float())


def quantize_tree(tree, cfg, path: str = "", *, tp: int = 1):
    """Replace every plan-covered dense ``{"w": ...}`` with ``{"qw":
    QuantizedWeight}`` and every plan-covered expert stack (``we_gate``,
    ``we_up``, ``we_down``) with a ``QuantizedWeight`` (the paper's offline
    pack step), per layer on the weights' device. Tags are path components
    ("layers.3.attn.wq"), matched by the plan's rules as in the reference;
    expert stacks resolve under the canonical "...moe.experts.<leaf>" tag,
    and the f32 router stays a raw array that no plan touches. ``path`` is
    the tag of ``tree`` itself when it is a subtree ("layers.3").

    ``tp`` packs the tree for ``tp`` ranks, as the reference does: each
    dense leaf gets its Megatron role (``TP_ROLES``), a row leaf's K is
    padded so every shard holds whole packed bytes and scale groups, and a
    column leaf whose N does not divide stays replicated (no role). The
    leaves stay whole; ``shard_tree`` keeps one rank's slice. Expert TP
    roles are not ported (ROADMAP queue 1, item 11)."""
    plan = cfg.quant
    if isinstance(tree, list):
        return [quantize_tree(v, cfg, f"{path}.{i}", tp=tp)
                for i, v in enumerate(tree)]
    if not isinstance(tree, dict):
        return tree

    def role_for(name: str, out_dim: int):
        role = TP_ROLES.get(name) if tp > 1 else None
        return None if role == "col" and out_dim % tp else role

    out = {}
    for k, v in tree.items():
        tag = f"{path}.{k}" if path else k
        if k in ("we_gate", "we_up", "we_down"):
            lp = plan.policy_for(f"{path}.experts.{k}" if path else f"experts.{k}")
            if lp is not None and v.ndim == 3 and role_for(k, v.shape[-1]):
                raise NotImplementedError(
                    f"{tag}: tensor-parallel expert leaves are not ported "
                    "yet: ROADMAP queue 1, item 11")
            out[k] = qlinear.quantize_expert_weight(v, lp) \
                if lp is not None and v.ndim == 3 else v
            continue
        lp = plan.policy_for(tag)
        if isinstance(v, dict) and "w" in v and v["w"].ndim == 2 and lp is not None:
            # When calibration is ported, keep the reference's rule
            # (lm.py:588-590 there): a static scale is stamped only on
            # lut_gemm leaves; bit-sliced leaves stay dynamic.
            if lp.a_scale == "static":
                raise NotImplementedError(
                    "static activation scales need the calibration pass, "
                    "which is not ported yet (ROADMAP queue 1, item 2)")
            q = {"qw": qlinear.quantize_weight(v["w"], lp, tp_shards=tp,
                                               tp_role=role_for(k, v["w"].shape[-1]))}
            if "b" in v:
                q["b"] = v["b"]
            out[k] = q
        else:
            out[k] = quantize_tree(v, cfg, tag, tp=tp)
    return out


def shard_tree(tree, rank: int, world: int):
    """``tree`` with every ``QuantizedWeight`` leaf replaced by rank
    ``rank``'s slice of it for ``world`` ranks (``qlinear.shard_weight``);
    every other array stays whole (replicated)."""
    if isinstance(tree, qlinear.QuantizedWeight):
        return qlinear.shard_weight(tree, rank, world)
    if isinstance(tree, list):
        return [shard_tree(v, rank, world) for v in tree]
    if isinstance(tree, dict):
        return {k: shard_tree(v, rank, world) for k, v in tree.items()}
    return tree


def qweights(tree, path: str = "") -> dict:
    """Every ``QuantizedWeight`` leaf of ``tree`` by its path
    ("layers.3.attn.wq.qw")."""
    if isinstance(tree, qlinear.QuantizedWeight):
        return {path: tree}
    items = enumerate(tree) if isinstance(tree, list) else \
        tree.items() if isinstance(tree, dict) else ()
    out = {}
    for k, v in items:
        tag = f"{path}.{k}" if path else str(k)
        out.update(qweights(v, tag))
    return out
