"""Fused-prologue bit-sliced LUT GEMM: the CUDA kernel
(``csrc/lut_gemm_bs_fused.cu``), its wrapper, and the plain PyTorch version.

Replaces ``src/repro/kernels/lut_gemm_bitsliced.py::lut_gemm_bs_fused_pallas``.
Raw bf16/f32 activations x (M, K) go in; each row is quantized to int8
codes (dynamic per-row amax in x's dtype, or the given f32 ``a_sc``), the
codes meet the (bits, N, K/4) two's-complement weight planes through
per-token 16-entry subset-sum tables, and the whole scale epilogue is
applied: ``(acc * w_scales[n]) * a_scale[m]`` per channel, or
``(sum_g acc_g * w_scales[n, g]) * a_scale[m]`` with group scales.

Callers go through ``kernels/registry.py``, which takes the plain version
for CPU tensors and the kernel (``lut_gemm_bs_fused_cuda``, which launches
or raises) for CUDA tensors. The reference's two-step kernel
(``lut_gemm_bitsliced_pallas``) serves only row-parallel leaves under a TP
mesh and comes with the TP slice (ROADMAP queue 1, item 11).

Bound on the H100 and design: see the note at the top of the CUDA source.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from . import build
from .ref import ref_lut_gemm_bs_fused

# weight widths the CUDA source instantiates (the plans use 2 and 4 bits)
KERNEL_BITS = (2, 4)
KERNEL_A_BITS = range(2, 9)


def lut_gemm_bs_fused_plain(x, w_planes, w_scales, a_sc=None, *, w_bits: int,
                            a_bits: int = 8, group_size=None) -> torch.Tensor:
    """The plain PyTorch version (any device)."""
    return ref_lut_gemm_bs_fused(x, w_planes, w_scales, a_sc, w_bits=w_bits,
                                 a_bits=a_bits, group_size=group_size)


def _check(x, w_planes, w_scales, a_sc, w_bits, a_bits,
           group_size) -> tuple[int, int, int]:
    if w_bits not in KERNEL_BITS or a_bits not in KERNEL_A_BITS:
        raise NotImplementedError(
            f"lut_gemm_bs_fused kernel: w{w_bits}a{a_bits} is not "
            f"instantiated (w_bits {KERNEL_BITS}, a_bits 2..8)")
    tensors = [x, w_planes, w_scales] + ([a_sc] if a_sc is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lut_gemm_bs_fused kernel: operands must be contiguous")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"lut_gemm_bs_fused kernel: x must be bf16 or f32, "
                        f"got {x.dtype}")
    if w_planes.dtype != torch.uint8:
        raise TypeError("lut_gemm_bs_fused kernel: planes must be uint8")
    if x.ndim != 2 or w_planes.ndim != 3 or w_planes.shape[0] != w_bits:
        raise ValueError(f"lut_gemm_bs_fused kernel: x (M, K) and planes "
                         f"({w_bits}, N, K/4) expected, got {tuple(x.shape)} "
                         f"and {tuple(w_planes.shape)}")
    M, K = x.shape
    N = w_planes.shape[1]
    if K % packing.BITPLANE_GROUP or w_planes.shape[2] * packing.BITPLANE_GROUP != K:
        raise ValueError(f"lut_gemm_bs_fused kernel: K={K} does not fit planes "
                         f"{tuple(w_planes.shape)} (K must be a multiple of "
                         f"{packing.BITPLANE_GROUP})")
    if group_size is None:
        want_sc = (N,)
    elif group_size % packing.BITPLANE_GROUP or K % group_size:
        raise ValueError(f"lut_gemm_bs_fused kernel: K={K} is not a multiple of "
                         f"group_size={group_size}, or the group is not a "
                         f"multiple of {packing.BITPLANE_GROUP}")
    else:
        want_sc = (N, K // group_size)
    if w_scales.dtype != torch.float32 or tuple(w_scales.shape) != want_sc:
        raise ValueError(f"lut_gemm_bs_fused kernel: scales must be f32 "
                         f"{want_sc}, got {w_scales.dtype} "
                         f"{tuple(w_scales.shape)}")
    if a_sc is not None and (a_sc.dtype != torch.float32
                             or tuple(a_sc.shape) not in ((1, 1), (M, 1))):
        raise ValueError(f"lut_gemm_bs_fused kernel: a_sc must be f32 (1, 1) "
                         f"or ({M}, 1), got {a_sc.dtype} {tuple(a_sc.shape)}")
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("lut_gemm_bs_fused kernel: every operand must be on "
                         "the same CUDA device")
    return M, N, K


def lut_gemm_bs_fused_cuda(x, w_planes, w_scales, a_sc=None, *, w_bits: int,
                           a_bits: int = 8, group_size=None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only)."""
    M, N, K = _check(x, w_planes, w_scales, a_sc, w_bits, a_bits, group_size)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = build.library("lut_gemm_bs_fused")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lut_gemm_bs_fused_launch(
        x.data_ptr(), w_planes.data_ptr(), w_scales.data_ptr(),
        a_sc.data_ptr() if a_sc is not None else None, out.data_ptr(),
        M, N, K, w_bits, a_bits, group_size or 0,
        int(x.dtype == torch.bfloat16), 0 if a_sc is None else a_sc.shape[0],
        stream)
    build.check(err, "lut_gemm_bs_fused")
    lut_gemm_bs_fused_cuda.launches += 1
    return out


lut_gemm_bs_fused_cuda.launches = 0
