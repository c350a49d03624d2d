"""Plain PyTorch oracles of the ported kernels (the port's copy of the
matching functions of ``repro/kernels/ref.py``).

Layouts, shared with the CUDA kernels:
  activations  A : (M, K)  packed along K -> (M, K/f)  uint8
  weights      W : (N, K)  packed along K -> (N, K/f)  uint8 (GEMM is A @ W^T)
  product LUT    : flat (2^(w_bits+a_bits),) -- entry [w_idx << a_bits | a_idx]
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
