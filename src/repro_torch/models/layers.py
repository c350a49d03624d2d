"""Transformer building blocks of the dense and MoE families, in torch.

The port's counterpart of ``repro/models/layers.py``: ``dense`` (plain or
packed-serving dispatch), RMSNorm, RoPE, the attention math (the same
masked softmax as the reference: an online softmax over key chunks for
prefill, a dense masked softmax for one-token decode), the int8 and int4
KV codecs, the attention layer's no-cache prefill branch, its dense slot
cache branch (the fixed-batch loop's one-token decode) and its paged
branches (chunked prefill, single-pass decode and split-KV decode), the
swiglu and geglu MLPs, and the GShard-style MoE layer (``moe_apply``: f32
router, top-k with capacity dropping, per-expert planned projections
through the registry's ``expert_dequant_matmul`` / ``expert_lut_gemm``,
and the shared expert).

One-token decode over an int8 or int4 cache goes through the registry:
``kv_cache_attention`` over a dense slot cache, ``paged_attention``
(kv_splits 1) or ``paged_attention_splitkv`` (kv_splits > 1) over a
pool. Their CUDA kernels replace the reference's Pallas kernels; the
reference itself attends through jnp on both paths (layers.py:515-607
and :608-638), and each op's plain version is that math. An unquantized
cache (the smoke configs) has no kernel: it attends in plain torch, as
the reference does. ``scaled_dot_product_attention`` is not used.

Local (sliding-window) layers attend over the last ``cfg.window`` rows on
every path, as the reference computes them: the cacheless prefill and the
chunked prefill mask (query - key) < window; the paged decode passes the
window to the attention op (rows >= pos + 1 - window), or masks the
gathered view; the fixed loop's dense slot cache of a local layer is a
ring of W = min(max_len, window) rows, row pos written at pos % window,
attended over its min(pos + 1, W) live rows. QAT waits for the training
slice.

A ring-paged local layer (``Engine(ring=True)``, ``ring_tables``): the pool
holds a ring of ring_len blocks a slot, absolute row t at ring block
(t // bs) % ring_len, offset t % bs, so the layer's memory is flat in the
context (the reference's layers.py:441-506). A one-token decode attends
through the same ops as without a ring, on the ring spelled out as an
absolute table (entry j: ring block j % ring_len) of the table's width:
the ops read only rows [pos + 1 - window, pos], which the ring holds, so
they see the rows, the width and hence the walk of the call without a
ring. A prefill chunk or a verify (S > 1) attends, one sequence at a time,
over the rows of its window and the chunk in absolute order, in the key
chunks of the gathered path without a ring, the rows below pos read from
the ring, then scatters the chunk into the ring: O(window + chunk) rows
gathered, not the table's, and that path's output bit for bit. Every
row a query can reach is live because R >= window + span - 1 (the
engine's sizing): a pad or rejected row written past the kept position
aliases a row a full R below it, outside every later window.

Cache updates happen in place: ``attn_apply`` writes the new K/V rows into
the slot cache or scatters them into the shared pool tensors instead of
returning new caches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import packing, quant
from repro_torch.core.qlinear import QuantizedWeight, dense_serve
from repro_torch.core.qplan import plan_backend
from repro_torch.kernels import registry
from repro_torch.kernels.paged_attention import merge_splitkv_partials, split_partition

_NEG = -1e30


def dense(p: dict, x: torch.Tensor, *, policy) -> torch.Tensor:
    """x: (..., in) -> (..., out). A packed leaf ({"qw": QuantizedWeight})
    runs through its plan's kernel route; a plain leaf ({"w": (in, out)})
    is a matmul in x's dtype."""
    if "qw" in p:
        qw: QuantizedWeight = p["qw"]
        if qw.kernel is None:
            raise NotImplementedError(
                "legacy (kernel=None) dequant-einsum leaves are not ported; "
                "pack under a QuantPlan")
        return dense_serve(qw, x, bias=p.get("b"), backend=plan_backend(policy))
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def norm_apply(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd // 2, dtype=torch.float32,
                                         device=device) / (hd // 2)))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, N, hd); positions: (B, S) or (1, S)."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs                  # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attn_chunk_size(sk: int) -> int:
    kc = min(1024, sk)
    while sk % kc:
        kc //= 2
    return max(kc, 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset=0, k_offset=None,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over key chunks (of ``chunk`` keys, default
    ``_attn_chunk_size(Sk)``). q (B, Sq, KV, G, hd), k/v (B, Sk, KV, hd)
    -> (B, Sq, KV, G, hd). ``q_offset`` is the absolute position of query
    row 0: an int, or a (B,) tensor per row. A local layer's ``window``
    keeps the keys with (query - key) < window. ``k_offset`` (a (B,)
    tensor, with a per-row ``q_offset``) is the absolute position of key
    row 0; None: key row j is at position j."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    scale = hd ** -0.5
    kc = chunk if chunk is not None else _attn_chunk_size(Sk)
    dev = q.device
    qf = q.float()
    per_row = torch.is_tensor(q_offset) and q_offset.ndim == 1
    qpos = (q_offset[:, None] if per_row else q_offset) \
        + torch.arange(Sq, device=dev)                   # (B, Sq) or (Sq,)
    koff = 0 if k_offset is None else k_offset[:, None, None]
    m = torch.full((B, KV, G, Sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, kc):
        kb = k[:, k0:k0 + kc].float()
        vb = v[:, k0:k0 + kc].float()
        s = torch.einsum("bqegh,bseh->begqs", qf, kb) * scale
        kpos = k0 + torch.arange(kb.shape[1], device=dev) + koff
        mask = torch.ones(torch.broadcast_shapes(qpos.shape + (1,), kpos.shape),
                          dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[..., None] >= kpos
        if window is not None:
            mask &= (qpos[..., None] - kpos) < window
        mask = mask[:, None, None] if per_row else mask
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("begqs,bseh->begqh", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B, KV, G, Sq, hd)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Single-query masked softmax. q (B, 1, KV, G, hd), caches (B, S, KV,
    hd), valid (B, S) bool."""
    hd = q.shape[-1]
    s = torch.einsum("bqegh,bseh->begqs", q.float(), k_cache.float()) * hd ** -0.5
    s = torch.where(valid[:, None, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("begqs,bseh->bqegh", p, v_cache.float())
    return out.to(q.dtype)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, KV, hd) -> (int8 codes, per-(token, head) f32 scales)."""
    xf = x.float()
    sc = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / sc[..., None]), -127, 127).to(torch.int8)
    return q, sc


def dequantize_kv(q: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    return q.float() * sc[..., None]


def quantize_kv4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, KV, hd) -> (4-bit codes packed two per byte along hd, low
    nibble first, (B, S, KV, hd/2) uint8; per-(token, head) f32 scales)."""
    xf = x.float()
    sc = torch.clamp(xf.abs().amax(dim=-1) / 7.0, min=1e-8)
    q = torch.clamp(torch.round(xf / sc[..., None]), -8, 7)
    return packing.pack((q + 8).to(torch.uint8), 4), sc


def dequantize_kv4(packed: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    return (packing.unpack(packed, 4).float() - 8.0) * sc[..., None]


KV_QUANT = {"int8": (quantize_kv, dequantize_kv),
            "int4": (quantize_kv4, dequantize_kv4)}
KV_BITS = {"int8": 8, "int4": 4}


def _cache_update(view: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write new (B, S, ...) into view (B, S_view, ...) at rows [pos,
    pos+S) of each batch row; the start clamps to [0, S_view - S] like the
    reference's dynamic_update_slice."""
    B, S = new.shape[:2]
    start = torch.clamp(pos, 0, view.shape[1] - S)
    rows = start[:, None] + torch.arange(S, device=view.device)
    view[torch.arange(B, device=view.device)[:, None], rows] = new.to(view.dtype)
    return view


def _scatter_pool_rows(pool: torch.Tensor, new: torch.Tensor, blk: torch.Tensor,
                       offs: torch.Tensor) -> None:
    """In place: scatter per-token rows new (B, S, ...) into the pool at
    (block, offset) coordinates blk / offs (both (B, S))."""
    B, S = blk.shape
    pool[blk.reshape(-1), offs.reshape(-1)] = new.reshape(
        B * S, *new.shape[2:]).to(pool.dtype)


def _splitkv_decode(q: torch.Tensor, cache: dict, block_tables: torch.Tensor,
                    pos: torch.Tensor, kv_splits: int,
                    window: Optional[int] = None) -> torch.Tensor:
    """Split-KV decode over an unquantized pool (reference layers.py:
    537-564): the table in ns chunks, one blocked masked softmax giving
    per-chunk unnormalised partials, merged exactly. q (B, 1, KV, G, hd);
    the new row is already in the pool; a local layer masks the rows at or
    below pos - window."""
    B, nb = block_tables.shape
    bs_tok = cache["k"].shape[1]
    hd = q.shape[-1]
    ns, nbc = split_partition(nb, kv_splits)
    tblp = torch.nn.functional.pad(block_tables, (0, ns * nbc - nb))

    def cgather(pool):                                   # (B, ns, nbc*bs, ..)
        return pool[tblp].reshape(B, ns, nbc * bs_tok, *pool.shape[2:]).float()

    idx = torch.arange(ns * nbc * bs_tok, device=q.device).reshape(ns, nbc * bs_tok)
    cvalid = idx[None] <= pos[:, None, None]
    if window is not None:
        cvalid &= idx[None] > pos[:, None, None] - window
    s = torch.einsum("begh,bnseh->bnegs", q[:, 0].float(),
                     cgather(cache["k"])) * hd ** -0.5
    s = torch.where(cvalid[:, :, None, None, :], s, _NEG)
    m_c = s.amax(-1)                                     # (B, ns, KV, G)
    pr = torch.exp(s - m_c[..., None])
    acc = torch.einsum("bnegs,bnseh->bnegh", pr, cgather(cache["v"]))
    return merge_splitkv_partials(acc, m_c, pr.sum(-1))[:, None].to(q.dtype)


def _dense_slot_decode(q, k, v, cache: dict, pos: torch.Tensor, cfg,
                       attn_backend: str, window: Optional[int] = None) -> torch.Tensor:
    """One-token decode over a dense slot cache (reference layers.py:
    608-638): write row ``pos`` of each sequence in place, then attend over
    rows <= pos. A local layer's cache is a ring of W rows (reference
    ``_ring_update``, layers.py:318): the row goes to pos % window, and the
    first min(pos + 1, W) rows are live. q (B, 1, KV, G, hd), k/v (B, 1,
    KV, hd)."""
    if q.shape[1] != 1:
        raise ValueError(f"a dense slot cache takes one-token decode steps, "
                         f"got {q.shape[1]} tokens")
    W = cache["k"].shape[1]
    at = pos if window is None else pos % window
    n = pos + 1 if window is None else torch.clamp(pos + 1, max=W)
    if cfg.kv_cache_dtype in KV_QUANT and "k_sc" in cache:
        qf = KV_QUANT[cfg.kv_cache_dtype][0]
        (k, k_sc), (v, v_sc) = qf(k), qf(v)
        for name, new in (("k", k), ("v", v), ("k_sc", k_sc), ("v_sc", v_sc)):
            _cache_update(cache[name], new, at)
        o = registry.dispatch("kv_cache_attention", q[:, 0], cache["k"],
                              cache["k_sc"], cache["v"], cache["v_sc"], n,
                              backend=attn_backend,
                              bits=KV_BITS[cfg.kv_cache_dtype])
        return o[:, None].to(q.dtype)
    _cache_update(cache["k"], k, at)
    _cache_update(cache["v"], v, at)
    valid = torch.arange(W, device=q.device)[None, :] < n[:, None]
    return decode_attention(q, cache["k"], cache["v"], valid)


def _prefill_attention(q, k, v, cfg, window: Optional[int]) -> torch.Tensor:
    """The cacheless causal prefill (reference layers.py:642-655): where
    ``cfg.kv_repeat`` > 1 and H % (KV * kv_repeat) == 0, the KV heads are
    repeated kv_repeat times and the query heads regrouped over them (the
    same attention, another grouping of its products), as the reference
    does; otherwise plain grouped attention."""
    B, S, KV, G, hd = q.shape
    rep = cfg.kv_repeat
    if rep > 1 and (KV * G) % (KV * rep) == 0:
        ka = k.repeat_interleave(rep, dim=2)
        va = v.repeat_interleave(rep, dim=2)
        qa = q.reshape(B, S, KV * rep, G // rep, hd)
        out = flash_attention(qa, ka, va, causal=True, window=window)
        return out.reshape(B, S, KV, G, hd)
    return flash_attention(q, k, v, causal=True, window=window)


def _ring_chunk_attention(q, k, v, cache: dict, ring: torch.Tensor,
                          pos: torch.Tensor, window: int, dqf,
                          kc: int) -> torch.Tensor:
    """A chunk of S > 1 rows over a ring-paged local layer, before its
    write, one sequence at a time as the gathered path does. Keys are the
    absolute rows [a0, a0 + L): a0 the window's first row for the chunk's
    first query, rounded down to a multiple of the gathered path's key
    chunk ``kc``, and L = kc * ceil((window + S + kc - 2) / kc), enough to
    pass the chunk's last row. Rows below pos come from the ring (row a at
    ring row a % R), rows from pos on from the chunk (q, k, v: (B, S, ...);
    k / v as the pool stores them: (codes, scales) pairs and their decoder
    ``dqf`` on an int8/int4 pool, else tensors); the rows no query may read
    hold whatever the ring does there. So every key chunk a query reads is
    the gathered path's chunk of the same rows, and the output is that
    path's bit for bit (a chunk with no live key leaves the online softmax
    exactly as it was)."""
    B, S = q.shape[:2]
    bs_tok = cache["k"].shape[1]
    R = ring.shape[1] * bs_tok
    L = kc * -(-(window + S + kc - 2) // kc)
    outs = []
    for b in range(B):
        a0 = torch.clamp(pos[b] - window + 1, min=0) // kc * kc
        a = a0 + torch.arange(L, device=q.device)
        slot = torch.remainder(a, R)
        blk, off = ring[b, slot // bs_tok], slot % bs_tok
        fresh = (a >= pos[b])[:, None, None]
        j = torch.clamp(a - pos[b], 0, S - 1)

        def rows(name, new, b=b):
            if dqf is None:
                return torch.where(fresh, new[b, j].to(cache[name].dtype),
                                   cache[name][blk, off])
            codes, sc = new
            return torch.where(fresh, dqf(codes[b, j], sc[b, j]),
                               dqf(cache[name][blk, off], cache[name + "_sc"][blk, off]))

        outs.append(flash_attention(q[b:b + 1], rows("k", k)[None], rows("v", v)[None],
                                    causal=True, window=window, q_offset=pos[b:b + 1],
                                    k_offset=a0[None], chunk=kc))
    return torch.cat(outs)


def attn_apply(p: dict, x: torch.Tensor, *, cfg, layer_type: str = "global",
               cache: Optional[dict] = None,
               pos: Optional[torch.Tensor] = None,
               block_tables: Optional[torch.Tensor] = None,
               ring_tables: Optional[torch.Tensor] = None,
               ring_abs: Optional[torch.Tensor] = None,
               kv_splits: int = 1, attn_backend: str = "auto",
               collect: Optional[list] = None) -> torch.Tensor:
    """Self-attention layer. x (B, S, D). A "local" ``layer_type`` attends
    over the last ``cfg.window`` rows on every path below (the module
    docstring). Without a cache: causal prefill over the whole sequence,
    over the raw K/V; ``collect``, where given, receives {"k", "v"}: the
    post-RoPE, unquantized K/V (B, S, KV, hd).

    With a dense slot cache (B, S_cache, ...) and no block tables: a
    one-token decode step (S == 1) at positions ``pos`` (B,). The new row
    is quantized (int8/int4 cache) and written at row ``pos`` in place;
    then an int8/int4 cache attends through the registry's
    ``kv_cache_attention`` op with lengths pos + 1 on ``attn_backend``,
    an unquantized one through ``decode_attention`` in plain torch, as
    the reference does.

    With a paged cache (pool dict) and block tables (B, nb), rows [pos,
    pos+S) are written into the pool in place:

    - one-token decode (S == 1) over an int8/int4 pool: scatter the new row,
      then the registry's ``paged_attention`` (kv_splits 1) or
      ``paged_attention_splitkv`` op with lengths pos + 1, on
      ``attn_backend`` ('auto': the kernel for CUDA tensors; 'ref': the
      plain version);
    - one-token decode over an unquantized pool with kv_splits > 1: scatter,
      then the split einsum;
    - otherwise: gather each row's blocks into a dense view, update it,
      attend (decode, or a chunked prefill with a per-row causal mask),
      then scatter.

    A local layer given ``ring_tables`` (B, ring_len) is ring-paged (the
    module docstring): its rows scatter into the ring; a one-token decode
    takes the paths above on ``ring_abs`` (B, nb), the ring as an absolute
    table of the block tables' width; a chunk attends over the ring's
    rows, then scatters."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    pol = cfg.quant
    window = cfg.window if layer_type == "local" else None
    q = dense(p["wq"], x, policy=pol).reshape(B, S, KV, G, hd)
    k = dense(p["wk"], x, policy=pol).reshape(B, S, KV, hd)
    v = dense(p["wv"], x, policy=pol).reshape(B, S, KV, hd)
    ar = torch.arange(S, device=x.device)
    positions = ar[None, :] if pos is None else pos[:, None] + ar[None, :]
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta
                   ).reshape(B, S, KV, G, hd)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if collect is not None:
            collect.append({"k": k, "v": v})
        out = _prefill_attention(q, k, v, cfg, window)
    elif block_tables is None:
        out = _dense_slot_decode(q, k, v, cache, pos, cfg, attn_backend, window)
    else:
        bs_tok = cache["k"].shape[1]
        quant_cache = cfg.kv_cache_dtype in KV_QUANT and "k_sc" in cache
        if quant_cache:
            qf, dqf = KV_QUANT[cfg.kv_cache_dtype]
            k, k_sc = qf(k)
            v, v_sc = qf(v)
        nb = block_tables.shape[1]
        rows = pos[:, None] + ar[None, :]                        # (B, S)
        ring = ring_tables if layer_type == "local" else None
        if ring is None:
            tables = block_tables
            blk = torch.gather(block_tables, 1,
                               torch.clamp(rows // bs_tok, max=nb - 1))
        else:
            tables = ring_abs
            # from the ring itself: the table's clamp would send a row past
            # its width onto the last entry, a live block of the ring
            blk = torch.gather(ring, 1, (rows // bs_tok) % ring.shape[1])
        offs = rows % bs_tok

        def scatter():
            _scatter_pool_rows(cache["k"], k, blk, offs)
            _scatter_pool_rows(cache["v"], v, blk, offs)
            if quant_cache:
                _scatter_pool_rows(cache["k_sc"], k_sc, blk, offs)
                _scatter_pool_rows(cache["v_sc"], v_sc, blk, offs)

        if S == 1 and quant_cache:
            scatter()
            ops = (q[:, 0], cache["k"], cache["k_sc"], cache["v"], cache["v_sc"],
                   tables, pos + 1)
            bits = KV_BITS[cfg.kv_cache_dtype]
            if kv_splits > 1:
                o = registry.dispatch("paged_attention_splitkv", *ops,
                                      backend=attn_backend, bits=bits,
                                      kv_splits=kv_splits, window=window)
            else:
                o = registry.dispatch("paged_attention", *ops,
                                      backend=attn_backend, bits=bits,
                                      window=window)
            out = o[:, None].to(q.dtype)
        elif S == 1 and kv_splits > 1:
            scatter()
            out = _splitkv_decode(q, cache, tables, pos, kv_splits, window)
        elif ring is not None:
            out = _ring_chunk_attention(q, (k, k_sc) if quant_cache else k,
                                        (v, v_sc) if quant_cache else v, cache, ring,
                                        pos, window, dqf if quant_cache else None,
                                        _attn_chunk_size(nb * bs_tok))
            scatter()
        else:
            S_view = nb * bs_tok

            def gather(pool):
                return pool[tables].reshape(B, S_view, *pool.shape[2:])

            kc = _cache_update(gather(cache["k"]), k, pos)
            vc = _cache_update(gather(cache["v"]), v, pos)
            if quant_cache:
                ksc = _cache_update(gather(cache["k_sc"]), k_sc, pos)
                vsc = _cache_update(gather(cache["v_sc"]), v_sc, pos)
                kd, vd = dqf(kc, ksc), dqf(vc, vsc)
            else:
                kd, vd = kc, vc
            if S == 1:
                idx = torch.arange(S_view, device=x.device)[None, :]
                valid = idx <= pos[:, None]
                if window is not None:     # paged by absolute position, masked
                    valid &= idx > pos[:, None] - window
                out = decode_attention(q, kd, vd, valid)
            else:
                # the per-row causal mask also blanks the not-yet-written
                # tail. One sequence at a time: CUDA's batched matmul picks
                # its algorithm by the batch count (at 16 query rows a row
                # rounds otherwise in a batch of 2 than alone), and a row of
                # a batched prefill chunk must get the bits it gets alone
                out = torch.cat([flash_attention(q[b:b + 1], kd[b:b + 1], vd[b:b + 1],
                                                 causal=True, window=window,
                                                 q_offset=pos[b:b + 1])
                                 for b in range(B)])
            scatter()
    out = out.reshape(B, S, H * hd)
    return dense(p["wo"], out, policy=pol)


def mlp_apply(p: dict, x: torch.Tensor, *, cfg) -> torch.Tensor:
    """The gated MLP: w_down(act(w_gate x) * w_up x), act silu (swiglu) or
    the tanh-approximated gelu (geglu)."""
    if cfg.mlp not in ("swiglu", "geglu"):
        raise NotImplementedError(f"mlp {cfg.mlp!r} is not ported yet")
    pol = cfg.quant
    up = dense(p["w_up"], x, policy=pol)
    g = dense(p["w_gate"], x, policy=pol)
    h = _silu_mul(g, up) if cfg.mlp == "swiglu" else _gelu_tanh(g) * up
    return dense(p["w_down"], h, policy=pol)


def _gelu_tanh(g: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(g) (approximate=True, its default): g * 0.5 * (1 +
    tanh(sqrt(2/pi) * (g + 0.044715 * g^3))), with g^3 as g * (g * g) (the
    reference's integer_pow) and every constant and op rounded in g's dtype
    (torch's F.gelu defaults to the erf form, and its tanh form rounds
    once)."""
    def c(v):
        return torch.tensor(v, dtype=g.dtype, device=g.device)

    inner = c(math.sqrt(2 / math.pi)) * (g + c(0.044715) * (g * (g * g)))
    return g * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def _silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu(g) * u, with the reference's sigmoid lowering
    1 / (1 + exp(-g)) rounded op by op in g's dtype (torch.sigmoid rounds
    once, which differs in bf16)."""
    return g * (1 / (1 + torch.exp(-g))) * u


def _expert_matmul(qw: QuantizedWeight, x: torch.Tensor, backend: str,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Planned expert projection: x (E, M, in) -> (E, M, out) f32 through
    the per-expert kernels, after the K padding ``quantize_expert_weight``
    applied; ``active`` (E,) flags the experts that hold a token (the others
    come out zero and their weights are not read), None computes all.
    w{b}a{b} leaves ('lut_gemm' with a product LUT) quantize each
    (e, m) row with its own dynamic scale, pack the codes and run
    ``expert_lut_gemm``; the per-channel weight scale and the activation
    scale are the epilogue here (a grouped leaf's K-group scales run in the
    op). Every other leaf, the bit-sliced plans' included, runs
    ``expert_dequant_matmul``. Unlike the reference, whose 'ref' backend
    computes the LUT route as a dequant einsum, the LUT route always
    dispatches the op; its plain version sums the same exact integer
    products per channel."""
    k_pad = qw.k_padded
    if k_pad != qw.in_features:
        x = torch.nn.functional.pad(x, (0, k_pad - qw.in_features))
    G = qw.group_size
    if qw.kernel == "lut_gemm" and qw.a_bits is not None and qw.plut is not None:
        a_scale = quant.group_scales(x.float(), qw.a_bits, None)[..., None]  # (E, M, 1)
        aq = quant.quantize(x, a_scale, bits=qw.a_bits, signed=True)
        a_idx = quant.to_index(aq, qw.a_bits, True)
        y = registry.dispatch(
            "expert_lut_gemm", packing.pack(a_idx, qw.a_bits), qw.packed, qw.plut,
            qw.scales if G is not None else None, w_bits=qw.bits,
            a_bits=qw.a_bits, scheme=qw.scheme, group_size=G, active=active,
            backend=backend)
        return y * a_scale if G is not None else y * qw.scales[:, None, :] * a_scale
    return registry.dispatch("expert_dequant_matmul", x.contiguous(), qw.packed,
                             qw.codebook, qw.scales, bits=qw.bits, group_size=G,
                             active=active, backend=backend)


def moe_capacity(moe, T: int) -> tuple[int, int]:
    """(dispatch group size, capacity per expert and group) for T tokens:
    the largest divisor of T not above ``moe.group_size``, and
    C = min(max(4, 2^ceil(log2(max(gs*K*cf/E, 1)))), gs)."""
    gs = min(moe.group_size, T)
    while T % gs:
        gs -= 1
    C = max(4, 2 ** math.ceil(math.log2(max(
        gs * moe.top_k * moe.capacity_factor / moe.n_experts, 1.0))))
    return gs, min(C, gs)


def moe_route(p: dict, xg: torch.Tensor, top_k: int):
    """f32 router over (G, gs, D) tokens: softmax probabilities, the top_k
    experts of each token (ties to the lower index, as ``jax.lax.top_k``)
    and their renormalised gates, both (G, gs, top_k)."""
    logits = xg.float() @ p["w_router"].float()                 # (G, gs, E)
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)
    gate_k, idx_k = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_k[..., :top_k], idx_k[..., :top_k]
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)
    return gate_k, idx_k


def moe_apply(p: dict, x: torch.Tensor, *, cfg) -> torch.Tensor:
    """x: (B, S, D). GShard dense-capacity dispatch, as the reference's
    ``moe_apply``: tokens in groups of gs, top-k routing, capacity C per
    expert and group filled slot by slot (every token's first choice in
    token order, then every second choice, ...) with the overflow dropped;
    the experts run on (E, G*C, D) in the activation dtype (rows of
    unfilled slots are zero), gate and up in f32 from a planned leaf,
    silu(gate) * up cast back to the activation dtype before the down
    projection; the gate-weighted combine is f32. The reference's one-hot
    dispatch and combine einsums are index gathers here: each kept
    assignment owns one (e, g, c) slot, so they move the same values. Pad
    rows of a prefill chunk and inactive decode rows take capacity as real
    tokens do, in the order the caller lays them out. The experts that no
    slot of any group holds a token for are flagged once a layer, on the
    device, and the expert ops skip them: their rows are zero, so their
    outputs are zero either way, and the combine reads only filled slots.
    A shared expert adds ``mlp_apply`` of x."""
    moe, pol = cfg.moe, cfg.quant
    B, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    T = B * S
    gs, C = moe_capacity(moe, T)
    Gn = T // gs
    dev = x.device
    gate_k, idx_k = moe_route(p, x.reshape(Gn, gs, D), K)

    # assignments in slot-major order: position q = j * gs + s of group g
    order = idx_k.transpose(1, 2).reshape(Gn, K * gs)
    oh = torch.nn.functional.one_hot(order, E)                  # (G, K*gs, E)
    pos = (oh.cumsum(dim=1) - 1).gather(-1, order[..., None])[..., 0]
    g_ix = torch.arange(Gn, device=dev)[:, None]
    n_slots = E * Gn * C
    slot = torch.where(pos < C, (order * Gn + g_ix) * C + pos, n_slots)
    tok = g_ix * gs + torch.arange(gs, device=dev).repeat(K)[None]
    src = torch.full((n_slots + 1,), T, dtype=torch.long, device=dev)
    src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    xs = torch.cat([x.reshape(T, D), x.new_zeros((1, D))])
    xe = xs[src[:n_slots]].reshape(E, Gn * C, D)                # (E, G*C, D)
    active = (src[:n_slots].view(E, Gn * C) < T).any(dim=1)     # (E,), no host sync

    be = plan_backend(pol)

    def proj(name, xin):                                        # -> (E, M, N)
        leaf = p[name]
        if isinstance(leaf, QuantizedWeight):
            if leaf.kernel is None:
                raise NotImplementedError(
                    "legacy (kernel=None) dequant-einsum leaves are not ported; "
                    "pack under a QuantPlan")
            return _expert_matmul(leaf, xin.to(x.dtype), be, active)  # f32
        return xin.to(x.dtype) @ leaf.to(x.dtype)

    h = _silu_mul(proj("we_gate", xe), proj("we_up", xe))
    eo = proj("we_down", h).reshape(n_slots, D).float()
    eo = torch.cat([eo, eo.new_zeros((1, D))])
    gates = gate_k.transpose(1, 2).reshape(Gn, K * gs)
    out = (eo[slot] * gates[..., None]).reshape(Gn, K, gs, D).sum(dim=1)
    out = out.reshape(B, S, D).to(x.dtype)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg=cfg)
    return out
