"""Plain PyTorch oracles of the ported kernels (the port's copy of the
matching functions of ``repro/kernels/ref.py``).

Layouts, shared with the CUDA kernels:
  activations  A : (M, K)  packed along K -> (M, K/f)  uint8
  weights      W : (N, K)  packed along K -> (N, K/f)  uint8 (GEMM is A @ W^T)
  product LUT    : flat (2^(w_bits+a_bits),) -- entry [w_idx << a_bits | a_idx]
  bit planes     : (bits, N, K/4) uint8 -- see packing.pack_bitplanes_signed
  out            : (M, N) float32

They run on whatever device their inputs lie on: the CPU tests use them,
and ``chip_smoke.py`` holds the kernels against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing, quant
from repro_torch.core.lut import ProductLUT

# elements of the (M, N, k-chunk) gather one step of ref_lut_gemm holds
_GATHER_BUDGET = 1 << 24
_G = packing.BITPLANE_GROUP  # activation codes per bit-plane pattern


def ref_lut_gemm(a_packed: torch.Tensor, w_packed: torch.Tensor,
                 lut: ProductLUT, w_scales: torch.Tensor | None = None,
                 group_size: int | None = None) -> torch.Tensor:
    """out[m, n] = sum_k lut[w_idx[n, k] << a_bits | a_idx[m, k]], f32.
    With group-wise weight scales (N, K/G): out = sum_g s[n, g] * sum_{k in
    g} lut[...]. K is walked in chunks (whole groups when scaled) so the
    (M, N, chunk) index tensor stays bounded at full-width shapes."""
    a_idx = packing.unpack(a_packed, lut.a_bits).long()          # (M, K)
    w_idx = packing.unpack(w_packed, lut.w_bits).long()          # (N, K)
    M, K = a_idx.shape
    N = w_idx.shape[0]
    table = lut.table.float()
    unit = group_size if w_scales is not None else 1
    kc = max(unit, _GATHER_BUDGET // max(M * N, 1) // unit * unit)
    out = torch.zeros((M, N), dtype=torch.float32, device=a_packed.device)
    for k0 in range(0, K, kc):
        k1 = min(K, k0 + kc)
        idx = (w_idx[None, :, k0:k1] << lut.a_bits) | a_idx[:, None, k0:k1]
        prods = table[idx]                                       # (M, N, kc)
        if w_scales is None:
            out += prods.sum(dim=-1)
        else:
            pg = prods.reshape(M, N, -1, group_size).sum(dim=-1)
            sc = w_scales[:, k0 // group_size:k1 // group_size].float()
            out += (pg * sc[None]).sum(dim=-1)
    return out


def ref_dequant_matmul(a: torch.Tensor, w_packed: torch.Tensor,
                       codebook: torch.Tensor, scales: torch.Tensor, bits: int,
                       group_size: int | None = None) -> torch.Tensor:
    """unpack -> codebook dequant -> matmul -> scale, f32 out (M, N).
    Group-wise scales (N, K/G) fold into the dequantized weight before the
    contraction; per-channel scales (N,) are the epilogue."""
    w_idx = packing.unpack(w_packed, bits).long()                # (N, K)
    w_deq = codebook.float()[w_idx]                              # (N, K)
    if group_size is not None:
        w_deq = w_deq * quant.expand_group_scales(scales.float(), group_size)
        return a.float() @ w_deq.T
    return (a.float() @ w_deq.T) * scales.float()[None, :]


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
    partial is scaled before the f32 sum over groups.

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
    accf = acc.permute(2, 0, 1).to(torch.float32)                # (M, N, K/G)
    return (accf * w_scales[None].float()).sum(-1)


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
