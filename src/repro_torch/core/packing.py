"""Sub-byte bit-packing (paper §4.1, Fig. 1/4, Tab. 3) on torch tensors.

The port's copy of ``repro/core/packing.py`` for schemes 'a', 'c' and 'd'.
Codes are packed along the LAST axis into uint8 carriers, slot i of a byte
holding code i at bits [SLOT_BITS*i, SLOT_BITS*(i+1)). Schemes 'c'/'d'
store the same bytes as 'a'; the reference's index-ready saving lives in
its unpack masks, which the CUDA kernels replace with their own shifts.
The bit-plane scheme 'bs' waits for the bit-sliced slice (ROADMAP queue 2,
item 1).
"""

from __future__ import annotations

import torch

# values-per-byte for each supported bitwidth
PACK_FACTOR = {1: 8, 2: 4, 3: 2, 4: 2, 8: 1}
# bit stride of each slot inside the byte (3-bit uses 4-bit slots)
SLOT_BITS = {1: 1, 2: 2, 3: 4, 4: 4, 8: 8}


def pack(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned b-bit codes (values in [0, 2^b)) along the last axis."""
    f, sb = PACK_FACTOR[bits], SLOT_BITS[bits]
    if f == 1:
        return idx.to(torch.uint8).contiguous()
    *lead, n = idx.shape
    if n % f:
        raise ValueError(f"axis length {n} not divisible by pack factor {f}")
    g = idx.reshape(*lead, n // f, f).to(torch.uint8)
    out = g[..., 0].clone(memory_format=torch.contiguous_format)
    for i in range(1, f):
        out |= g[..., i] << (sb * i)
    return out                                  # row-major, as kernels read it


def unpack(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of pack: (..., n//f) uint8 -> (..., n) uint8 codes."""
    f, sb = PACK_FACTOR[bits], SLOT_BITS[bits]
    if f == 1:
        return packed.to(torch.uint8)
    mask = 2 ** bits - 1
    parts = [(packed >> (sb * i)) & mask for i in range(f)]
    return torch.stack(parts, dim=-1).reshape(*packed.shape[:-1],
                                              packed.shape[-1] * f)


def pack_indexready(w_idx: torch.Tensor, bits: int) -> torch.Tensor:
    """Scheme 'c'/'d' weight packing: the natural byte layout."""
    return pack(w_idx, bits)
