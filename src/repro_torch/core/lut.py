"""Product lookup tables (paper §3, Figs. 2-3): ``table[(w_idx << a_bits) |
a_idx]`` holds the product of the weight and activation levels, precomputed
once so the GEMM only gathers and adds."""

from __future__ import annotations

import dataclasses

import torch

from .quant import Codebook


@dataclasses.dataclass(frozen=True)
class ProductLUT:
    """Flat product table: ``table[w_idx * 2^a_bits + a_idx]``."""
    table: torch.Tensor   # (2^(w_bits + a_bits),)
    w_bits: int
    a_bits: int


def product_lut(w_codebook: Codebook | torch.Tensor,
                a_codebook: Codebook | torch.Tensor) -> ProductLUT:
    """All products w_level * a_level, f32."""
    wl = w_codebook.levels if isinstance(w_codebook, Codebook) else w_codebook
    al = a_codebook.levels if isinstance(a_codebook, Codebook) else a_codebook
    w_bits = int(wl.shape[-1]).bit_length() - 1
    a_bits = int(al.shape[-1]).bit_length() - 1
    tbl = (wl[:, None] * al[None, :]).to(torch.float32)
    return ProductLUT(tbl.reshape(-1), w_bits, a_bits)
