"""The bit-sliced LUT GEMMs: two CUDA kernels (``csrc/lut_gemm_bs_fused.cu``
and ``csrc/lut_gemm_bitsliced.cu``, one integer core in
``csrc/bs_common.cuh``), their wrappers, and their plain PyTorch versions.

``lut_gemm_bs_fused`` replaces
``src/repro/kernels/lut_gemm_bitsliced.py::lut_gemm_bs_fused_pallas``.
Raw bf16/f32 activations x (M, K) go in; each row is quantized to int8
codes (dynamic per-row amax in x's dtype, or the given f32 ``a_sc``), the
codes meet the (bits, N, K/4) two's-complement weight planes through
per-token 16-entry subset-sum tables, and the whole scale epilogue is
applied: ``(acc * w_scales[n]) * a_scale[m]`` per channel, or
``(sum_g acc_g * w_scales[n, g]) * a_scale[m]`` with group scales.

``lut_gemm_bitsliced`` replaces ``lut_gemm_bitsliced_pallas`` (the
reference's two-step route): int8 activation codes (M, K) in, the exact
integer sums ``sum_k w[n, k] * a_codes[m, k]`` out as f32, or with group
scales ``sum_g f32(partial_g) * w_scales[n, g]``, groups summed in
ascending order. ``dense_serve`` sends a bit-sliced leaf here only when it
is row-parallel under an active TP context: the rows are quantized once on
the replicated activations, each rank runs this op on its K slice, and one
all-reduce sums the partials.

Callers go through ``kernels/registry.py``, which takes the plain version
for CPU tensors and the kernel (``*_cuda``, which launches or raises) for
CUDA tensors.

Bound on the H100 and design: see the notes at the top of the CUDA sources.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from . import build
from .ref import ref_lut_gemm_bitsliced, ref_lut_gemm_bs_fused

# weight widths the CUDA sources instantiate (the plans use 2 and 4 bits)
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


def lut_gemm_bitsliced_plain(a_codes, w_planes, w_scales=None, *, w_bits: int,
                             a_bits: int = 8, group_size=None) -> torch.Tensor:
    """The plain PyTorch version of the two-step op (any device)."""
    del a_bits                        # the codes arrive quantized
    return ref_lut_gemm_bitsliced(a_codes, w_planes, w_scales, bits=w_bits,
                                  group_size=group_size)


def _check_two_step(a_codes, w_planes, w_scales, w_bits, a_bits,
                    group_size) -> tuple[int, int, int]:
    if w_bits not in KERNEL_BITS or a_bits not in KERNEL_A_BITS:
        raise NotImplementedError(
            f"lut_gemm_bitsliced kernel: w{w_bits}a{a_bits} is not "
            f"instantiated (w_bits {KERNEL_BITS}, a_bits 2..8)")
    if (w_scales is None) != (group_size is None):
        raise ValueError("lut_gemm_bitsliced kernel: w_scales go with "
                         "group_size (per-channel scales are the caller's "
                         "epilogue)")
    tensors = [t for t in (a_codes, w_planes, w_scales) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lut_gemm_bitsliced kernel: operands must be contiguous")
    if a_codes.dtype != torch.int8 or w_planes.dtype != torch.uint8:
        raise TypeError(f"lut_gemm_bitsliced kernel: int8 codes and uint8 "
                        f"planes expected, got {a_codes.dtype} and "
                        f"{w_planes.dtype}")
    if a_codes.ndim != 2 or w_planes.ndim != 3 or w_planes.shape[0] != w_bits:
        raise ValueError(f"lut_gemm_bitsliced kernel: codes (M, K) and planes "
                         f"({w_bits}, N, K/4) expected, got "
                         f"{tuple(a_codes.shape)} and {tuple(w_planes.shape)}")
    M, K = a_codes.shape
    N = w_planes.shape[1]
    if K % packing.BITPLANE_GROUP or w_planes.shape[2] * packing.BITPLANE_GROUP != K:
        raise ValueError(f"lut_gemm_bitsliced kernel: K={K} does not fit planes "
                         f"{tuple(w_planes.shape)} (K must be a multiple of "
                         f"{packing.BITPLANE_GROUP})")
    if group_size is not None:
        if group_size % packing.BITPLANE_GROUP or K % group_size:
            raise ValueError(f"lut_gemm_bitsliced kernel: K={K} is not a "
                             f"multiple of group_size={group_size}, or the "
                             f"group is not a multiple of "
                             f"{packing.BITPLANE_GROUP}")
        want = (N, K // group_size)
        if w_scales.dtype != torch.float32 or tuple(w_scales.shape) != want:
            raise ValueError(f"lut_gemm_bitsliced kernel: scales must be f32 "
                             f"{want}, got {w_scales.dtype} "
                             f"{tuple(w_scales.shape)}")
    if any(t.device.type != "cuda" or t.device != a_codes.device for t in tensors):
        raise ValueError("lut_gemm_bitsliced kernel: every operand must be on "
                         "the same CUDA device")
    return M, N, K


def lut_gemm_bitsliced_cuda(a_codes, w_planes, w_scales=None, *, w_bits: int,
                            a_bits: int = 8, group_size=None) -> torch.Tensor:
    """Launch the two-step CUDA kernel on the current stream (CUDA tensors
    only)."""
    M, N, K = _check_two_step(a_codes, w_planes, w_scales, w_bits, a_bits,
                              group_size)
    out = torch.empty((M, N), dtype=torch.float32, device=a_codes.device)
    if M == 0 or N == 0:
        return out
    lib = build.library("lut_gemm_bitsliced")
    stream = torch.cuda.current_stream(a_codes.device).cuda_stream
    err = lib.lut_gemm_bitsliced_launch(
        a_codes.data_ptr(), w_planes.data_ptr(),
        w_scales.data_ptr() if w_scales is not None else None, out.data_ptr(),
        M, N, K, w_bits, group_size or 0, stream)
    build.check(err, "lut_gemm_bitsliced")
    lut_gemm_bitsliced_cuda.launches += 1
    return out


lut_gemm_bitsliced_cuda.launches = 0
