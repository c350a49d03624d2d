"""Sub-byte bit-packing (paper §4.1, Fig. 1/4, Tab. 3) on torch tensors.

The port's copy of ``repro/core/packing.py`` for schemes 'a', 'c', 'd'
and the bit planes of scheme 'bs'. Codes are packed along the LAST axis
into uint8 carriers, slot i of a byte holding code i at bits
[SLOT_BITS*i, SLOT_BITS*(i+1)). Schemes 'c'/'d' store the same bytes as
'a'; the reference's index-ready saving lives in its unpack masks, which
the CUDA kernels replace with their own shifts.
"""

from __future__ import annotations

from functools import reduce

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


# --------------------------------------------------------------------------- #
# Bit-sliced planes (T-MAC decomposition), scheme 'bs'
# --------------------------------------------------------------------------- #
#
# A b-bit signed weight w = idx - 2^(b-1) is split into b one-bit planes of
# u = idx XOR 2^(b-1): w = sum_{j<b-1} 2^j u_j - 2^(b-1) u_{b-1}. Plane j's
# byte g holds bit j of codes [g*4, g*4+4) in its low BITPLANE_GROUP bits,
# a pattern that indexes a 16-entry per-token table of activation subset
# sums. A pattern byte carries only 4 bits, so a b-bit weight takes
# b * K/4 bytes per output channel: twice the natural packing's K/PACK_FACTOR
# at 2 and at 4 bits.

BITPLANE_GROUP = 4  # K codes per pattern byte; the table has 2^g entries


def bitplane_packed_len(k: int) -> int:
    if k % BITPLANE_GROUP:
        raise ValueError(f"K={k} not divisible by plane group {BITPLANE_GROUP}")
    return k // BITPLANE_GROUP


def pack_bitplanes(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., N, K) uint8 codes -> (..., bits, N, K/4) uint8 patterns:
    pattern bit i of plane j's byte g is bit j of code g*4+i. The plane
    axis sits at -3, so stacked leaves keep planes next to the (N, K/4)
    matrix."""
    *lead, n, k = idx.shape
    g = idx.reshape(*lead, n, bitplane_packed_len(k), BITPLANE_GROUP) \
        .to(torch.uint8)
    planes = []
    for b in range(bits):
        bit = (g >> b) & 1
        planes.append(reduce(torch.bitwise_or,
                             [bit[..., j] << j for j in range(BITPLANE_GROUP)]))
    return torch.stack(planes, dim=-3).contiguous()


def unpack_bitplanes(planes: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of pack_bitplanes: (..., bits, N, K/4) -> (..., N, K) codes."""
    *lead, nplanes, n, kg = planes.shape
    if nplanes != bits:
        raise ValueError(f"{nplanes} planes for {bits}-bit codes")
    pat = torch.movedim(planes, -3, 0)                  # (bits, ..., N, K/4)
    slots = []
    for j in range(BITPLANE_GROUP):
        code = torch.zeros(pat.shape[1:], dtype=torch.uint8, device=planes.device)
        for b in range(bits):
            code = code | (((pat[b] >> j) & 1) << b)
        slots.append(code)
    return torch.stack(slots, dim=-1).reshape(*lead, n, kg * BITPLANE_GROUP)


def pack_bitplanes_signed(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """Planes of the signed value idx - 2^(b-1): XOR-ing the top bit makes
    the plane coefficients ``bitplane_coeffs(bits)``, so no per-row
    correction term is needed in the kernel."""
    return pack_bitplanes(idx.to(torch.uint8) ^ (1 << (bits - 1)), bits)


def unpack_bitplanes_signed(planes: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of pack_bitplanes_signed: recovers the unsigned storage idx."""
    return unpack_bitplanes(planes, bits) ^ (1 << (bits - 1))


def bitplane_coeffs(bits: int) -> tuple[int, ...]:
    """Per-plane signed coefficients: (1, 2, ..., 2^(b-2), -2^(b-1))."""
    return tuple(1 << j for j in range(bits - 1)) + (-(1 << (bits - 1)),)
