"""Uniform affine quantization primitives (the port's copy of the parts of
``repro/core/quant.py`` that serving reads).

Conventions as in the reference: signed codes live in
[-2^(b-1), 2^(b-1) - 1]; stored indices are ``q - qmin`` in [0, 2^b).
Arithmetic keeps the input dtype (a bf16 amax and scale stay bf16) and
rounds half to even, so activation codes match the reference bit for bit.
LSQ fake-quant and k-means codebooks wait for the training slice (ROADMAP
queue 1, item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def qrange(bits: int, signed: bool) -> tuple[int, int]:
    """(qmin, qmax) inclusive for a bitwidth/signedness."""
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2 ** bits - 1


def _floor_eps(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``max(x, eps)`` in x's dtype (eps rounds to it, as the reference's
    weakly typed scalar does)."""
    return torch.clamp(x, min=eps)


def compute_scale_zero_point(x: torch.Tensor, bits: int, *, signed: bool = True,
                             axis: Optional[int] = None, eps: float = 1e-8):
    """Symmetric amax calibration: (scale, zero_point = 0), reduced over
    every axis but ``axis`` (kept as size 1 when ``axis`` is set). The
    reference's asymmetric variant has no caller on the serving path."""
    qmin, qmax = qrange(bits, signed)
    dims = tuple(i for i in range(x.ndim) if axis is None or i != axis % x.ndim)
    amax = torch.amax(x.abs(), dim=dims, keepdim=axis is not None)
    scale = _floor_eps(amax / max(abs(qmin), qmax), eps)
    return scale, torch.zeros_like(scale)


def group_scales(x: torch.Tensor, bits: int, group_size: Optional[int] = None,
                 *, signed: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """Symmetric amax scales along the LAST axis: (..., K) -> (...,) per
    row, or (..., K/G) per contiguous K-group with ``group_size`` G."""
    qmin, qmax = qrange(bits, signed)
    if group_size is not None:
        K = x.shape[-1]
        if K % group_size:
            raise ValueError(f"K={K} is not a multiple of group {group_size}")
        x = x.reshape(*x.shape[:-1], K // group_size, group_size)
    amax = torch.amax(x.abs(), dim=-1)
    return _floor_eps(amax / max(abs(qmin), qmax), eps)


def expand_group_scales(scales: torch.Tensor, group_size: int) -> torch.Tensor:
    """(..., K/G) group scales -> (..., K) per-element scales."""
    return torch.repeat_interleave(scales, group_size, dim=-1)


def quantize(x: torch.Tensor, scale, zero_point=0.0, *, bits: int,
             signed: bool = True) -> torch.Tensor:
    """Real -> integer code (paper Eq. 1): round half to even in x's dtype,
    clip, int8 carrier (int16 when the code range exceeds int8)."""
    qmin, qmax = qrange(bits, signed)
    q = torch.round(x / scale + zero_point)
    carrier = torch.int8 if qmax <= 127 else torch.int16
    return torch.clamp(q, qmin, qmax).to(carrier)


def to_index(q: torch.Tensor, bits: int, signed: bool = True) -> torch.Tensor:
    """Signed code -> unsigned storage index in [0, 2^b), uint8."""
    qmin, _ = qrange(bits, signed)
    return (q.to(torch.int32) - qmin).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class Codebook:
    """2^bits float levels, ascending; ``levels[idx]`` dequantizes."""
    levels: torch.Tensor   # (2^bits,) float32


def uniform_codebook(bits: int, signed: bool = True, device=None) -> Codebook:
    qmin, qmax = qrange(bits, signed)
    return Codebook(torch.arange(qmin, qmax + 1, dtype=torch.float32,
                                 device=device))
