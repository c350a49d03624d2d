"""Plain PyTorch oracles of the ported kernels (the port's copy of the
matching functions of ``repro/kernels/ref.py``).

Layouts, shared with the CUDA kernels:
  activations  A : (M, K)  packed along K -> (M, K/f)  uint8
  weights      W : (N, K)  packed along K -> (N, K/f)  uint8 (GEMM is A @ W^T)
  product LUT    : flat (2^(w_bits+a_bits),) -- entry [w_idx << a_bits | a_idx]
  bit planes     : (bits, N, K/4) uint8 -- see packing.pack_bitplanes_signed
  out            : (M, N) float32
  expert GEMMs   : the same with a leading expert axis, (E, M, K/f) x
                   (E, N, K/f) -> (E, M, N)
  KV pool        : (n_blocks, bs, KV, hd) int8 codes, or (..., hd/2) uint8
                   with two 4-bit codes per byte (low nibble first), plus
                   (n_blocks, bs, KV) f32 per-(token, head) scales

They run on whatever device their inputs lie on: the CPU tests use them,
and ``chip_smoke.py`` holds the kernels against them on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import packing, quant
from repro_torch.core.lut import ProductLUT

# elements of the (..., M, N, k-chunk) gather one step of ref_lut_gemm holds
_GATHER_BUDGET = 1 << 24
_G = packing.BITPLANE_GROUP  # activation codes per bit-plane pattern


def ref_lut_gemm(a_packed: torch.Tensor, w_packed: torch.Tensor,
                 lut: ProductLUT, w_scales: torch.Tensor | None = None,
                 group_size: int | None = None) -> torch.Tensor:
    """out[..., m, n] = sum_k lut[w_idx[..., n, k] << a_bits | a_idx[..., m,
    k]], f32, over any leading axes the two operands share (the expert axis
    of ``ref_expert_lut_gemm``). With group-wise weight scales (..., N, K/G):
    out = sum_g s[n, g] * sum_{k in g} lut[...]. K is walked in chunks
    (whole groups when scaled) so the (..., M, N, chunk) index tensor stays
    bounded at full-width shapes."""
    a_idx = packing.unpack(a_packed, lut.a_bits).long()          # (..., M, K)
    w_idx = packing.unpack(w_packed, lut.w_bits).long()          # (..., N, K)
    *lead, M, K = a_idx.shape
    N = w_idx.shape[-2]
    table = lut.table.float()
    unit = group_size if w_scales is not None else 1
    cells = math.prod(lead) * M * N
    kc = max(unit, _GATHER_BUDGET // max(cells, 1) // unit * unit)
    out = torch.zeros((*lead, M, N), dtype=torch.float32, device=a_packed.device)
    for k0 in range(0, K, kc):
        k1 = min(K, k0 + kc)
        idx = (w_idx[..., None, :, k0:k1] << lut.a_bits) | a_idx[..., :, None, k0:k1]
        prods = table[idx]                                       # (..., M, N, kc)
        if w_scales is None:
            out += prods.sum(dim=-1)
        else:
            pg = prods.reshape(*prods.shape[:-1], -1, group_size).sum(dim=-1)
            sc = w_scales[..., k0 // group_size:k1 // group_size].float()
            out += (pg * sc.unsqueeze(-3)).sum(dim=-1)
    return out


def _dequant(w_packed: torch.Tensor, codebook: torch.Tensor, scales: torch.Tensor,
             bits: int, group_size: int | None) -> torch.Tensor:
    """(..., N, K/f) codes -> (..., N, K) f32 codebook levels, times the
    group scales when grouped (per-channel scales are the epilogue)."""
    codes = packing.unpack(w_packed, bits)
    w_deq = codebook.float().index_select(0, codes.reshape(-1).int()).view(codes.shape)
    if group_size is not None:
        w_deq = w_deq * quant.expand_group_scales(scales.float(), group_size)
    return w_deq


def ref_dequant_matmul(a: torch.Tensor, w_packed: torch.Tensor,
                       codebook: torch.Tensor, scales: torch.Tensor, bits: int,
                       group_size: int | None = None) -> torch.Tensor:
    """unpack -> codebook dequant -> matmul -> scale, f32 out (..., M, N),
    over any leading axes the operands share (the expert axis of
    ``ref_expert_dequant_matmul``). Group-wise scales (..., N, K/G) fold
    into the dequantized weight before the contraction; per-channel scales
    (..., N) are the epilogue."""
    y = a.float() @ _dequant(w_packed, codebook, scales, bits,
                             group_size).transpose(-1, -2)
    return y if group_size is not None else y * scales.float().unsqueeze(-2)


# the per-expert oracles (reference ref.py:290-322): the general ones over
# the leading expert axis, x (E, M, K) or a (E, M, K/f), w (E, N, K/f)
ref_expert_dequant_matmul = ref_dequant_matmul
ref_expert_lut_gemm = ref_lut_gemm


# threads of a warp (butterfly_sum's lanes)
WARP = 32


# k-lanes of a block of csrc/dense_common.cuh (its warps): lane j walks the
# 4-byte weight words j, j + 8, ... of a window
DENSE_LANES = 8
# f32 elements of block sums tile_order_matmul holds at once (16 MB: the
# passes over them stay in a card's L2)
_BLOCK_BUDGET = 1 << 22


def tile_order_matmul(a: torch.Tensor, w: torch.Tensor, *, ranks: int,
                      k_per_rank: int, word: int,
                      group_scales: torch.Tensor | None = None,
                      group_size: int | None = None) -> torch.Tensor:
    """a (..., M, K) f32 @ w (..., N, K).T f32 -> (..., M, N) in the CUDA
    dequant walk's order (``tile_order_sum`` with each term the product
    a[m, k] * w[n, k])."""
    return tile_order_sum(a, w, lambda x, y: x.unsqueeze(-1) * y.unsqueeze(-2),
                          ranks=ranks, k_per_rank=k_per_rank, word=word,
                          group_scales=group_scales, group_size=group_size)


def tile_order_sum(a: torch.Tensor, w: torch.Tensor, term, *, ranks: int,
                   k_per_rank: int, word: int, pads: tuple = (0, 0),
                   group_scales: torch.Tensor | None = None,
                   group_size: int | None = None) -> torch.Tensor:
    """sum_k term(a[..., m, k], w[..., n, k]) -> (..., M, N) f32, over any
    leading axes the operands share (the expert axis of the expert GEMM),
    summed in the order of the CUDA walks on csrc/dense_common.cuh's tiling:
    the dequant walk (csrc/dense_dequant.cuh), whose terms are products,
    and the LUT walk (csrc/dense_lut.cuh), whose terms are table entries of
    code units. ``term`` maps one unit's (chunk, C x lanes, L, M) and
    (chunk, C x lanes, L, N) slices to (chunk, C x lanes, L, M, N) f32 terms,
    and gives +0 where an operand holds its pad value (``pads``: a's, w's).
    K (in units) is cut into windows of ``k_per_rank`` units, rank c of the
    cluster taking windows c, c + ranks, ... (rounds); in each window
    k-lane j takes the words of ``word`` units j, j + DENSE_LANES, ...; each
    block of 8 units is summed term by term into a block sum (times its
    group's scale with ``group_scales`` (..., N, K / group_size),
    group_size a multiple of 8), and the block sums are added one by one
    into the lane's sum (each term, scaling and sum rounded to f32; where
    the dequant kernel fuses multiply and add the products are exact, which
    gives the same bits); the lanes' sums then meet in a pairwise tree
    ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)), and the ranks' partials are
    added in rank order. K is padded to whole rounds with the pad values,
    whose +0 terms leave every sum as it is where the kernel skips. Every
    leading index runs at once (no loop over experts) and nothing syncs
    with the host, so CUDA graphs can capture it. This replays the
    kernels' present schedule: a kernel that changes its walk, its merge or
    its rounding must change this function with it."""
    *lead, M, K = a.shape
    N = w.shape[-2]
    L = math.prod(lead)
    a, w = a.reshape(L, M, K), w.reshape(L, N, K)
    lanes, step, nb = DENSE_LANES, DENSE_LANES * word, word // 8
    span = ranks * k_per_rank
    rounds = -(-K // span)
    pad = rounds * span - K
    if pad:
        a = torch.nn.functional.pad(a, (0, pad), value=pads[0])
        w = torch.nn.functional.pad(w, (0, pad), value=pads[1])
    steps = k_per_rank // step
    # lane steps of the last round's longest window (its rank 0's): the
    # steps past it hold only zeros, which leave every sum as it is
    last = -(-min(k_per_rank, K - (rounds - 1) * span) // step)

    def blocks(x):
        """(L, rows, K) -> (the blocks in a lane's order, 8, C x lanes, L,
        rows). First K outermost, a plain transpose (each cached line of x
        is read again while it is cached), then the blocks in order, which
        moves whole (L, rows) planes."""
        n_lead, rows = x.shape[:2]
        xt = x.reshape(n_lead * rows, -1).t().contiguous() \
            .view(rounds, ranks, steps, lanes, nb, 8, n_lead, rows) \
            .permute(0, 2, 4, 5, 1, 3, 6, 7)
        x_blocks = xt[-1, :last].flatten(0, 1)
        if rounds > 1:
            x_blocks = torch.cat([xt[:-1].flatten(0, 2), x_blocks])
        return x_blocks.reshape(-1, 8, ranks * lanes, n_lead, rows)

    xa, xw = blocks(a), blocks(w)
    n_blocks = xa.shape[0]
    if group_scales is not None:                  # each block's group (the last past K)
        k_pos = torch.arange(a.shape[-1], device=a.device, dtype=torch.float32)
        k0 = blocks(k_pos[None, None])[:, 0, :, 0, 0]             # (blocks, C x lanes)
        g = (k0.long() // group_size).clamp(max=group_scales.shape[-1] - 1)
        gs = group_scales.float().reshape(L, N, -1)
        scale = gs[:, :, g].permute(2, 3, 0, 1).unsqueeze(-2)     # (blocks, CL, L, 1, N)
    acc = torch.zeros((ranks * lanes, L, M, N), dtype=torch.float32, device=a.device)
    chunk = max(1, _BLOCK_BUDGET // acc.numel())
    for b0 in range(0, n_blocks, chunk):          # the blocks in order, a chunk at a time
        b1 = min(n_blocks, b0 + chunk)
        # the chunk's block sums at once, term by term; the first term
        # stands for 0 + itself, which differs only where it is -0, and a
        # -0 block sum leaves every lane's sum as it is
        part = term(xa[b0:b1, 0], xw[b0:b1, 0])
        for q in range(1, 8):
            part += term(xa[b0:b1, q], xw[b0:b1, q])
        if group_scales is not None:
            part *= scale[b0:b1]
        for b in range(b1 - b0):                  # block sums into the lanes' sums
            acc += part[b]
    acc = acc.view(ranks, lanes, L, M, N)
    while acc.shape[1] > 1:                       # the lanes' pairwise tree
        acc = acc[:, 0::2] + acc[:, 1::2]
    out = acc[0, 0]
    for c in range(1, ranks):
        out = out + acc[c, 0]
    return out.reshape(*lead, M, N).contiguous()


def tile_order_lut_gemm(a_packed: torch.Tensor, w_packed: torch.Tensor,
                        table: torch.Tensor, *, w_bits: int, a_bits: int, ranks: int,
                        k_per_rank: int) -> torch.Tensor:
    """``ref_lut_gemm`` per channel with its sums in the CUDA LUT walk's
    order (``tile_order_sum`` on the kernel's tiling: ``ranks`` windows of
    ``k_per_rank`` codes), so kernel and replay agree bit for bit for any
    f32 table, a float one (k-means levels) included. A unit is one code,
    or at w2a2 a pair of neighbouring codes whose term is the pair table's
    entry LUT[w0, a0] + LUT[w1, a1] (rounded once, as the kernel builds
    it); a word holds 32 / unit-bits units. Pad units read an extra table
    row of zeros."""
    a_idx = packing.unpack(a_packed, a_bits).long()              # (..., M, K)
    w_idx = packing.unpack(w_packed, w_bits).long()              # (..., N, K)
    lut = table.float().view(2 ** w_bits, 2 ** a_bits)           # [w, a]
    if (w_bits, a_bits) == (2, 2):              # code pairs on the w4a4 walk
        a_idx = a_idx[..., 0::2] | (a_idx[..., 1::2] << 2)
        w_idx = w_idx[..., 0::2] | (w_idx[..., 1::2] << 2)
        ap = torch.arange(16, device=table.device)[:, None]
        wp = torch.arange(16, device=table.device)[None, :]
        tab = lut[wp & 3, ap & 3] + lut[wp >> 2, ap >> 2]         # [a pair, w pair]
        ub, per = 4, 2
    else:
        tab, ub, per = lut.t(), w_bits, 1                        # [a, w]
    tab = torch.cat([tab, tab.new_zeros((1, tab.shape[1]))]).reshape(-1)
    n_w = 2 ** ub

    def term(x, y):
        return torch.take(tab, x.unsqueeze(-1) * n_w + y.unsqueeze(-2))

    return tile_order_sum(a_idx, w_idx, term, ranks=ranks, k_per_rank=k_per_rank // per,
                          word=32 // ub, pads=(tab.numel() // n_w - 1, 0))


def tile_order_dequant_matmul(a: torch.Tensor, w_packed: torch.Tensor,
                              codebook: torch.Tensor, scales: torch.Tensor,
                              bits: int, group_size: int | None, *, ranks: int,
                              k_per_rank: int) -> torch.Tensor:
    """``ref_dequant_matmul`` with its contraction in the CUDA dequant walk's
    order (``tile_order_matmul`` on the kernel's tiling: ``ranks`` windows
    of ``k_per_rank`` codes, words of 32 / bits codes), over any leading
    axes the operands share (``dequant_matmul``, and ``expert_dequant_matmul``
    with its expert axis), so kernel and replay agree bit for bit. Group
    scales multiply each 8 codes' sum where the group is a multiple of 8
    codes, else fold into the levels, as there."""
    kw = dict(ranks=ranks, k_per_rank=k_per_rank, word=32 // bits)
    if group_size is None:
        y = tile_order_matmul(a.float(), _dequant(w_packed, codebook, scales, bits, None), **kw)
        return y * scales.float().unsqueeze(-2)
    if group_size % 8 == 0:
        return tile_order_matmul(a.float(), _dequant(w_packed, codebook, scales, bits, None),
                                 group_scales=scales, group_size=group_size, **kw)
    return tile_order_matmul(a.float(), _dequant(w_packed, codebook, scales, bits, group_size),
                             **kw)


def butterfly_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (a power of two long) as lane 0 of a CUDA xor
    butterfly (warp_sum) does: halves added pairwise until one is left."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _bitplane_pattern_matrix(device=None) -> torch.Tensor:
    """(4, 16) int16 with P[j, p] = bit j of pattern p: the matrix that
    turns a group of 4 activation codes into its 16-entry subset-sum LUT."""
    p = torch.arange(2 ** _G, device=device)
    return torch.stack([(p >> j) & 1 for j in range(_G)]).to(torch.int16)


def _paired_plane_terms(lut16: torch.Tensor, w_planes: torch.Tensor, bits: int):
    """Fold bit-plane pairs into combined tables so one gather covers two
    planes: for planes (p, p+1) with coefficients (c0, c1),
    clut[..., hi*16 + lo] = c1*lut16[..., hi] + c0*lut16[..., lo], indexed
    by pat[p] | pat[p+1] << 4 (exact in int16: |entry| <= 12*4*128). Odd
    ``bits`` leaves one trailing single-plane term. Returns
    [(idx (N, K/4) int64, clut (..., entries) int16, |c0|+|c1|), ...]."""
    coeffs = packing.bitplane_coeffs(bits)
    entries = lut16.shape[-1]
    terms = []
    for p in range(0, bits - 1, 2):
        c0, c1 = coeffs[p], coeffs[p + 1]
        clut = (c1 * lut16[..., :, None] + c0 * lut16[..., None, :]) \
            .reshape(*lut16.shape[:-1], entries * entries)
        idx = w_planes[p].long() | (w_planes[p + 1].long() << _G)
        terms.append((idx, clut, abs(c0) + abs(c1)))
    if bits % 2:
        c = coeffs[bits - 1]
        terms.append((w_planes[bits - 1].long(), lut16 * c, abs(c)))
    return terms


def _int16_run(coef_sum: int, G: int) -> int:
    """Longest pattern run whose int16 partial sums provably cannot
    overflow: run * coef_sum * 4 * 128 < 2^15 with the int8 code
    carrier (|code| <= 128), and run must divide G. 1 when no run is safe.
    The w4 high pair (coef_sum 12) bounds runs at 4."""
    bound = coef_sum * _G * 128
    for run in (32, 16, 8, 4, 2):
        if run * bound < (1 << 15) and G % run == 0:
            return run
    return 1


def ref_lut_gemm_bitsliced(a_codes: torch.Tensor, w_planes: torch.Tensor,
                           w_scales: torch.Tensor | None = None, *, bits: int,
                           group_size: int | None = None) -> torch.Tensor:
    """Bit-sliced LUT GEMM oracle (T-MAC decomposition). The per-token LUT
    holds subset sums of 4 consecutive activation codes,
    lut[m, kg, p] = sum_j bit_j(p) * a[m, kg*4+j] (int16); plane pairs fold
    into combined tables (``_paired_plane_terms``), and

        out[m, n] = sum_k (idx[n,k] - 2^(b-1)) * a_codes[m, k]

    exactly, in integers (exact in f32: |out| < 2^24 at the supported
    widths). With ``w_scales``/``group_size`` each scale group's integer
    partial is scaled, then the groups are summed in f32 in ascending
    order, one rounding per product and per sum: the order the two-step
    kernel (csrc/lut_gemm_bitsliced.cu) sums them in.

    The reference lays its gather out per M regime for XLA:CPU (a
    lane-packed int32 gather for M >= 2). That is a layout trick that sums
    the same exact integers, so this version uses the simple (N, G, M)
    gather for every M, walked over N in chunks so the gather stays bounded
    at full width. Ungrouped sums run in int16 for ``_int16_run`` patterns
    at a time, as the reference does."""
    M, K = a_codes.shape
    nplanes, N, G = w_planes.shape
    if nplanes != bits or G * _G != K:
        raise ValueError(f"planes {tuple(w_planes.shape)} do not fit codes "
                         f"{tuple(a_codes.shape)} at {bits} bits")
    if group_size is not None and (group_size % _G or K % group_size):
        raise ValueError(f"group_size {group_size} does not fit K={K}")
    pat = _bitplane_pattern_matrix(a_codes.device)
    a = a_codes.reshape(M, G, _G).to(torch.int16)
    lut16 = (a[..., None] * pat).sum(-2, dtype=torch.int16)      # (M, G, 16)
    gg = group_size // _G if group_size is not None else G
    nc = max(1, _GATHER_BUDGET // max(G * M, 1))
    acc = torch.zeros((N, G // gg, M), dtype=torch.int32, device=a_codes.device)
    for idx, clut, coef_sum in _paired_plane_terms(lut16, w_planes, bits):
        entries = clut.shape[-1]
        lutT = clut.permute(1, 2, 0).reshape(G * entries, M)
        offs = torch.arange(G, device=a_codes.device) * entries
        run = _int16_run(coef_sum, G) if group_size is None else 1
        for n0 in range(0, N, nc):
            flat = (idx[n0:n0 + nc] + offs).reshape(-1)
            s = lutT[flat].reshape(-1, G, M)                     # (nc, G, M)
            if run > 1:
                s = s.reshape(-1, G // run, run, M).sum(2, dtype=torch.int16)
            acc[n0:n0 + nc] += s.reshape(s.shape[0], G // gg, -1, M) \
                .sum(2, dtype=torch.int32)
    if group_size is None:
        # row-major like the kernel's output: a transposed view would send
        # the layers after it down other (differently rounding) matmul paths
        return acc[:, 0].T.contiguous().to(torch.float32)        # (M, N)
    part = acc.permute(2, 0, 1).to(torch.float32) * w_scales[None].float()
    out = part[..., 0].contiguous()                              # (M, N)
    for g in range(1, part.shape[-1]):
        out = out + part[..., g]
    return out


def ref_lut_gemm_bs_fused(x: torch.Tensor, w_planes: torch.Tensor,
                          w_scales: torch.Tensor,
                          a_sc: torch.Tensor | None = None, *, w_bits: int,
                          a_bits: int = 8, group_size: int | None = None) -> torch.Tensor:
    """Fused-prologue bit-sliced GEMM oracle: quantize the activations with
    the exact ``quant.compute_scale_zero_point`` + ``quant.quantize`` ops
    (a bf16 ``x`` keeps a bf16 amax and scale), run the integer bit-sliced
    core, and apply the full scale epilogue. ``a_sc`` — a (1, 1) static or
    (M, 1) explicit f32 scale — replaces the per-row calibration as-is.
    Per channel: (acc * w_scales[n]) * a_scale[m]; grouped:
    (sum_g acc_g * w_scales[n, g]) * a_scale[m]."""
    if a_sc is not None:
        a_scale = a_sc
    else:
        a_scale, _ = quant.compute_scale_zero_point(x, a_bits, signed=True,
                                                    axis=0)      # (M, 1)
    aq = quant.quantize(x, a_scale, bits=a_bits, signed=True)
    if group_size is not None:
        y = ref_lut_gemm_bitsliced(aq, w_planes, w_scales, bits=w_bits,
                                   group_size=group_size)
        return y * a_scale
    y = ref_lut_gemm_bitsliced(aq, w_planes, bits=w_bits)
    return y * w_scales[None, :] * a_scale


# --------------------------------------------------------------------------- #
# Decode attention over a packed KV cache (reference ref.py:325-425)
# --------------------------------------------------------------------------- #

def _unpack4(codes: torch.Tensor) -> torch.Tensor:
    """(..., hd/2) uint8 -> (..., hd) int32 codes, low nibble first (the
    rule of the reference's kv_cache_attention.py:27-33)."""
    lo = codes & 0xF
    hi = (codes >> 4) & 0xF
    return torch.stack([lo, hi], dim=-1).reshape(
        *codes.shape[:-1], codes.shape[-1] * 2).to(torch.int32)


def dequant_kv_tile(codes: torch.Tensor, sc: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed codes (..., hd/f) + scales (...) -> f32 (..., hd): int8 is
    code * scale, int4 is (nibble - 8) * scale (kv_cache_attention.py:36-42
    of the reference)."""
    if bits == 4:
        vals = _unpack4(codes).to(torch.float32) - 8.0
    else:
        vals = codes.to(torch.float32)
    return vals * sc.float()[..., None]


def _window_mask(pos: torch.Tensor, lengths: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """(B, S) rows t < lengths[b], and on a local layer t >= lengths[b] -
    window: the reference's t > pos - window with pos = lengths[b] - 1."""
    mask = pos[None, :] < lengths[:, None]
    if window is not None:
        mask &= pos[None, :] >= lengths[:, None] - window
    return mask


def ref_kv_cache_attention(q: torch.Tensor, k_packed: torch.Tensor,
                           k_sc: torch.Tensor, v_packed: torch.Tensor,
                           v_sc: torch.Tensor, lengths: torch.Tensor,
                           bits: int, window: Optional[int] = None) -> torch.Tensor:
    """Oracle: dequantize the whole cache (B, S, KV, hd/f), masked softmax
    of the (B, KV, G, hd) queries over rows < lengths[b] (and, with a
    ``window``, rows >= lengths[b] - window), f32 out."""
    kd = dequant_kv_tile(k_packed, k_sc, bits)
    vd = dequant_kv_tile(v_packed, v_sc, bits)
    hd = q.shape[-1]
    s = torch.einsum("begh,bseh->begs", q.float(), kd) * hd ** -0.5
    mask = _window_mask(torch.arange(kd.shape[1], device=q.device), lengths, window)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("begs,bseh->begh", p, vd)


def ref_paged_attention(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths,
                        bits: int, window: Optional[int] = None) -> torch.Tensor:
    """Oracle: gather each sequence's blocks into a dense view, then the
    flat packed-cache oracle over it (masked to the ``window`` of a local
    layer)."""
    B, nb = block_tables.shape
    bs = k_pool.shape[1]

    def view(pool):
        return pool[block_tables].reshape(B, nb * bs, *pool.shape[2:])

    return ref_kv_cache_attention(q, view(k_pool), view(k_sc), view(v_pool),
                                  view(v_sc), lengths, bits, window)


def ref_paged_attention_splitkv(q, k_pool, k_sc, v_pool, v_sc, block_tables,
                                lengths, bits: int, kv_splits: int = 2,
                                window: Optional[int] = None) -> torch.Tensor:
    """Oracle of the flash-decoding split: ns = min(kv_splits, nb) chunks of
    nbc = ceil(nb / ns) table entries (the tail padded with block 0), plain
    per-chunk unnormalised partials (acc, m, l), and the exact merge written
    out here, so the oracle shares no code with what it checks. A local
    layer's ``window`` masks the rows below lengths[b] - window; a chunk
    with no row left carries m = -1e30 and weighs exactly 0."""
    B, nb = block_tables.shape
    bs = k_pool.shape[1]
    ns = max(1, min(int(kv_splits), nb))
    nbc = -(-nb // ns)
    tbl = torch.nn.functional.pad(block_tables, (0, ns * nbc - nb))
    hd = q.shape[-1]
    qf = q.float()
    o_parts, m_parts, l_parts = [], [], []
    for c in range(ns):
        ids = tbl[:, c * nbc:(c + 1) * nbc]                      # (B, nbc)
        kd = dequant_kv_tile(k_pool[ids], k_sc[ids], bits)
        vd = dequant_kv_tile(v_pool[ids], v_sc[ids], bits)
        kd = kd.reshape(B, nbc * bs, *kd.shape[3:])
        vd = vd.reshape(B, nbc * bs, *vd.shape[3:])
        s = torch.einsum("begh,bseh->begs", qf, kd) * hd ** -0.5
        pos = c * nbc * bs + torch.arange(nbc * bs, device=q.device)
        mask = _window_mask(pos, lengths, window)
        s = torch.where(mask[:, None, None, :], s, -1e30)
        m_c = s.amax(-1)                                         # (B, KV, G)
        p = torch.exp(s - m_c[..., None])
        o_parts.append(torch.einsum("begs,bseh->begh", p, vd))
        m_parts.append(m_c)
        l_parts.append(p.sum(-1))
    o = torch.stack(o_parts, dim=1)                              # (B, ns, KV, G, hd)
    m = torch.stack(m_parts, dim=1)                              # (B, ns, KV, G)
    ll = torch.stack(l_parts, dim=1)
    M = m.amax(dim=1)
    w = torch.exp(m - M[:, None])
    num = (o * w[..., None]).sum(dim=1)
    den = (ll * w).sum(dim=1)
    return num / torch.clamp(den, min=1e-30)[..., None]
