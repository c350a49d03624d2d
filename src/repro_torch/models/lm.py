"""Decoder-only LM assembly (dense, MoE and recurrent families) for the
port.

The port's counterpart of ``repro/models/lm.py``. Parameters are a plain
dict: the input embedding (V, D), ``tok_embed`` when the head is tied to
it or ``in_embed`` beside an untied ``lm_head`` {"w": (D, V)}, which every
plan keeps bf16 (``qplan.KEEP_BF16``); ``final_norm``; and ``layers``, a
list with one dict per layer (``ln1``, ``attn`` {wq, wk, wv, wo},
``ln2``, and ``mlp`` {w_gate, w_up, w_down} or, on the layers
``cfg.moe_flags()`` marks, ``moe`` {w_router (D, E) f32, we_gate/we_up
(E, D, F), we_down (E, F, D), shared {w_gate, w_up, w_down}}); a
``recurrent`` layer holds ``rnn`` (models/recurrent.py: w_rnn_in,
w_rnn_gate, w_rnn_out, conv_w, conv_b, lru_*) in place of ``attn``, and
an ``rwkv`` layer only ``rwkv`` (its own two layernorms, time and channel
mix); weights keep the reference's (in, out) layout. The reference's
``lax.scan`` over stacked superblocks is a Python loop over ``layers``
here.

Caches are a flat list with one dict per layer, in ``layers`` order,
updated in place: the paged engine's block pools (serving/cache.py), or
the fixed-batch loop's dense slot caches (``init_cache``,
``prefill_to_cache``), one (B, S) slot per sequence; a local layer's slot
is a ring of S = min(max_len, window) rows. Both lay a layer out as
``_layer_cache`` does: k/v codes with f32 scales for an int8 or int4
cache, k/v in the model dtype otherwise. A recurrent layer's entry is its
state, one row per sequence (per slot in the engine), keyed as the
reference's: {"rnn": {"h", "conv"}} or {"rwkv": {"s", "shift_t",
"shift_c"}}; a forward with caches advances it in place (only the rows
``active`` marks, where given).

Each layer's type ("global", "local", "recurrent" or "rwkv",
``cfg.layer_types()``) comes from the config's pattern, as the
reference's superblocks give it; a local layer attends over the last
``cfg.window`` rows (``layers.attn_apply``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import STATE_TYPES
from repro_torch.core import calibrate, qlinear
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import TP_ROLES
from . import layers as L
from . import recurrent as R

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


LAYER_TYPES = ("global", "local", "recurrent", "rwkv")


def _check_supported(cfg) -> None:
    if cfg.family not in ("dense", "moe", "hybrid", "ssm") or any(
            t not in LAYER_TYPES for t in cfg.pattern):
        raise NotImplementedError(
            f"{cfg.name}: only the dense, MoE and recurrent (hybrid, ssm) "
            "families are ported; the others follow ROADMAP queue 1, item 9")
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
    norm scales; the recurrent leaves as ``rglru_init`` / ``rwkv_init``
    draw them: ``conv_w`` normal * 0.1, ``lru_a`` linspace 2-6, the LoRA
    mixes normal * 0.01, ``mix_x`` uniform, ``decay_w`` linspace -6 to -1,
    ``bonus_u`` normal * 0.1), not its bits. Layers are MoE where
    ``cfg.moe_flags()`` says so, recurrent where ``cfg.layer_types()``
    does. With ``pack`` each layer goes through the plan's packer right
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

    def const(*shape, value=0.0):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def linspace(lo, hi, n):
        return torch.linspace(lo, hi, n, dtype=torch.float32, device=dev).to(dtype)

    def norm(kind=cfg.norm):
        p = {"scale": const(D, value=1.0)}
        if kind == "layernorm":
            p["bias"] = const(D)
        return p

    def rnn():
        Rw, cw = cfg.d_rnn or D, cfg.conv_width
        return {"w_rnn_in": dense(D, Rw), "w_rnn_gate": dense(D, Rw),
                "w_rnn_out": dense(Rw, D), "conv_w": normal(cw, Rw, std=0.1),
                "conv_b": const(Rw), "lru_a": linspace(2.0, 6.0, Rw),
                "lru_in_w": const(Rw, value=1.0), "lru_in_b": const(Rw),
                "lru_rec_w": const(Rw, value=1.0), "lru_rec_b": const(Rw)}

    def rwkv():
        Ld = R.RWKV_LORA
        return {"w_r": dense(D, D), "w_k": dense(D, D), "w_v": dense(D, D),
                "w_g": dense(D, D), "w_out": dense(D, D),
                "mix_x": torch.rand((5, D), generator=generator, device=dev,
                                    dtype=torch.float32).to(dtype),
                "mix_lora_a": normal(D, Ld, std=0.01),
                "mix_lora_b": normal(5, Ld, D, std=0.01),
                "decay_w": linspace(-6.0, -1.0, D),
                "decay_lora_a": normal(D, 2 * Ld, std=0.01),
                "decay_lora_b": normal(2 * Ld, D, std=0.01),
                "bonus_u": normal(D, std=0.1), "ln_scale": const(D, value=1.0),
                "wc_k": dense(D, F), "wc_v": dense(F, D), "wc_r": dense(D, D),
                "ln1": norm("layernorm"), "ln2": norm("layernorm")}

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
    for i, (t, is_moe) in enumerate(zip(cfg.layer_types(), cfg.moe_flags())):
        if t == "rwkv":
            lp = {"rwkv": rwkv()}
        else:
            mixer = {"rnn": rnn()} if t == "recurrent" else \
                {"attn": {"wq": dense(D, H * hd, cfg.qkv_bias),
                          "wk": dense(D, KV * hd, cfg.qkv_bias),
                          "wv": dense(D, KV * hd, cfg.qkv_bias),
                          "wo": dense(H * hd, D)}}
            lp = {"ln1": norm(), **mixer, "ln2": norm()}
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
    sequence for every attention layer, of ``slot_rows`` rows (a local
    layer's ring), and a zero state per sequence for every recurrent one;
    an unquantized cache and the states' conv and shift rows hold the model
    dtype."""
    _check_supported(cfg)
    dev, dtype = resolve_device(device), torch_dtype(cfg.dtype)
    return [R.state_init(cfg, t, batch, dtype, dev) if t in STATE_TYPES
            else _layer_cache(cfg, batch, slot_rows(cfg, t, max_len), dtype, dev)
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
    1e-8 and code 0, as in the reference). A recurrent layer's entry, the
    prompt's final state, passes through."""
    out = []
    for i, kv in enumerate(prefill_caches):
        layer_type = cfg.layer_type(i)
        if layer_type in STATE_TYPES:
            out.append(kv)             # the prompt's final state, as it is
            continue
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
                collect: Optional[list] = None,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pre-norm decoder layer: x + mixer(ln1(x)), then + mlp(ln2(.)) or
    + moe(ln2(.)); the mixer is attention, or the RG-LRU on a
    ``recurrent`` layer. An ``rwkv`` layer is the whole RWKV6 block, which
    owns both residuals. ``collect`` receives the layer's K/V (see
    ``layers.attn_apply``), or a recurrent layer's final state; with a
    cache a recurrent layer reads its state and writes the new one in
    place (``active``: only those rows)."""
    if layer_type == "rwkv":
        st = None if cache is None else cache["rwkv"]
        y, new = R.rwkv_apply(p["rwkv"], x, cfg=cfg, state=st)
        _keep_state(st, new, "rwkv", collect, active)
        return y
    h = L.norm_apply(p["ln1"], x, cfg.norm)
    if layer_type == "recurrent":
        st = None if cache is None else cache["rnn"]
        y, new = R.rglru_apply(p["rnn"], h, cfg=cfg, state=st)
        _keep_state(st, new, "rnn", collect, active)
        x = x + y
    else:
        x = x + L.attn_apply(p["attn"], h, cfg=cfg, layer_type=layer_type,
                             cache=cache, pos=pos,
                             block_tables=block_tables, ring_tables=ring_tables,
                             ring_abs=ring_abs, kv_splits=kv_splits,
                             attn_backend=attn_backend, collect=collect)
    h2 = L.norm_apply(p["ln2"], x, cfg.norm)
    if "moe" in p:
        return x + L.moe_apply(p["moe"], h2, cfg=cfg)
    return x + L.mlp_apply(p["mlp"], h2, cfg=cfg)


def _keep_state(state: Optional[dict], new: dict, key: str,
                collect: Optional[list], active: Optional[torch.Tensor]) -> None:
    """A recurrent layer's new state: written into ``state`` in place (in
    its dtypes; where ``active`` (B,) is given, only its rows: the others
    keep theirs, as the reference's ``select_slots``), or without a state
    appended to ``collect`` as {key: new}."""
    if state is None:
        if collect is not None:
            collect.append({key: new})
        return
    for name, cur in state.items():
        val = new[name].to(cur.dtype)
        if active is not None:
            val = torch.where(active.view(-1, *(1,) * (cur.ndim - 1)), val, cur)
        cur.copy_(val)


def forward(params: dict, cfg, tokens: torch.Tensor, *,
            caches: Optional[list] = None, pos: Optional[torch.Tensor] = None,
            block_tables: Optional[torch.Tensor] = None,
            ring_tables: Optional[torch.Tensor] = None,
            ring_abs: Optional[torch.Tensor] = None, kv_splits=1,
            attn_backend: str = "auto", collect_cache: bool = False,
            active: Optional[torch.Tensor] = None):
    """Token ids (B, S) -> (final hidden states (B, S, D), caches).

    Without caches: a causal forward over the whole sequence; with
    ``collect_cache`` the returned caches are each layer's post-RoPE,
    unquantized K/V ({"k", "v"}, (B, S, KV, hd)) for ``prefill_to_cache``
    (a recurrent layer's entry its final state), else None. With paged caches and block tables (B, nb): S == 1 is a
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
    (B, nb), the same rings as absolute tables (``layers.attn_apply``).
    Recurrent layers read and advance their states in the caches (dense or
    paged alike: one row per batch row); ``active`` (B,) bool limits the
    advance to its rows (the engine's decode step: idle and prefilling
    slots keep their state)."""
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
                        collect=collected, active=active)
    h = L.norm_apply(params["final_norm"], x, cfg.norm)
    return h, caches if collected is None else collected


def logits_fn(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) f32 logits against the tied embedding or the
    untied ``lm_head``: a plain f32 product outside any kernel, as the
    reference's einsum with an f32 accumulator. A legacy plan packs the
    head too (its skip list does not name it): the product then takes its
    dequantized weight in the hidden states' dtype, as the reference's."""
    if cfg.tie_embeddings:
        return torch.matmul(hidden.float(), params["tok_embed"].float().T)
    head = params["lm_head"]
    w = qlinear.dequant_weight(head["qw"]).to(hidden.dtype) if "qw" in head else head["w"]
    return torch.matmul(hidden.float(), w.float())


def quantize_tree(tree, cfg, path: str = "", *, tp: int = 1,
                  act_scales: Optional[dict] = None):
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
    roles are not ported (ROADMAP queue 1, item 11). A legacy leaf
    (``kernel`` None) takes no role: its plain product runs whole on every
    rank.

    ``cfg.quant`` is a ``QuantPlan`` or, for the legacy config, a single
    ``QuantPolicy`` (its ``skip`` list keeps layer classes bf16; a policy
    without ``w_bits`` leaves the tree as it is). ``act_scales`` (from
    ``calibrate_act_scales``) gives each layer class its activation amax: a
    policy with ``a_scale`` 'static' stamps ``amax / qmax`` on a
    ``lut_gemm`` leaf (``a_sc``), as the reference's ``static_for`` does;
    bit-sliced leaves and uncalibrated tags stay dynamic."""
    plan = cfg.quant
    if isinstance(plan, qlinear.QuantPolicy) and plan.w_bits is None:
        return tree
    if isinstance(tree, list):
        return [quantize_tree(v, cfg, f"{path}.{i}", tp=tp, act_scales=act_scales)
                for i, v in enumerate(tree)]
    if not isinstance(tree, dict):
        return tree

    def role_for(name: str, out_dim: int, lp):
        role = TP_ROLES.get(name) if tp > 1 and lp.kernel is not None else None
        return None if role == "col" and out_dim % tp else role

    def static_for(tag: str, lp) -> Optional[float]:
        if (lp.a_scale != "static" or lp.a_bits is None
                or lp.resolved_kernel() != "lut_gemm"):
            return None
        amax = calibrate.lookup(act_scales, tag)
        return None if amax is None else calibrate.static_scale(amax, lp.a_bits)

    out = {}
    for k, v in tree.items():
        tag = f"{path}.{k}" if path else k
        if k in ("we_gate", "we_up", "we_down"):
            lp = plan.policy_for(f"{path}.experts.{k}" if path else f"experts.{k}")
            if lp is not None and v.ndim == 3 and role_for(k, v.shape[-1], lp):
                raise NotImplementedError(
                    f"{tag}: tensor-parallel expert leaves are not ported "
                    "yet: ROADMAP queue 1, item 11")
            out[k] = qlinear.quantize_expert_weight(v, lp) \
                if lp is not None and v.ndim == 3 else v
            continue
        lp = plan.policy_for(tag)
        if isinstance(v, dict) and "w" in v and v["w"].ndim == 2 and lp is not None:
            q = {"qw": qlinear.quantize_weight(
                v["w"], lp, tp_shards=tp, tp_role=role_for(k, v["w"].shape[-1], lp),
                a_static=static_for(tag, lp))}
            if "b" in v:
                q["b"] = v["b"]
            out[k] = q
        else:
            out[k] = quantize_tree(v, cfg, tag, tp=tp, act_scales=act_scales)
    return out


def calibrate_act_scales(params: dict, cfg, batches) -> dict:
    """The offline calibration pass for static activation scales: the plain
    (unpacked) forward over ``batches`` (dicts with "tokens" (B, S)) inside
    ``calibrate.collect_act_stats``; returns the per-layer-class amax dict
    ("attn.wq", "mlp.w_up", "moe.shared.w_down", ...) for
    ``quantize_tree(..., act_scales=...)``."""
    with torch.inference_mode(), calibrate.collect_act_stats() as stats:
        for batch in batches:
            forward(params, cfg, batch["tokens"])
    return dict(stats)


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
