"""Product-LUT GEMM: the CUDA kernel (``csrc/lut_gemm.cu``), its wrapper,
and the plain PyTorch version.

Replaces ``src/repro/kernels/lut_gemm.py::lut_gemm_pallas``.
``out[m, n] = sum_k LUT[(w[n, k] << a_bits) | a[m, k]]`` in f32, with an
optional group-scale epilogue ``sum_g s[n, g] * sum_{k in g} LUT[...]``.
Weights may be packed under scheme 'a', 'c' or 'd' (the same bytes).

Callers go through ``kernels/registry.py``, which takes the plain version
for CPU tensors and the kernel (``lut_gemm_cuda``, which launches or
raises) for CUDA tensors.

Bound on the H100 and design: see the note at the top of the CUDA source
(launch- and gather-bound at the serving shapes; one warp per output
column, the whole LUT in shared memory, f32 accumulation, warp-shuffle
reduction).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import packing
from repro_torch.core.lut import ProductLUT
from . import build
from .ref import ref_lut_gemm

# (w_bits, a_bits) pairs the CUDA source instantiates
KERNEL_BITS = ((2, 2), (2, 8), (4, 4), (4, 8))


def lut_gemm_plain(a_packed, w_packed, lut_table, w_scales=None, *,
                   w_bits: int, a_bits: int, group_size=None) -> torch.Tensor:
    """The plain PyTorch version (any device)."""
    return ref_lut_gemm(a_packed, w_packed, ProductLUT(lut_table, w_bits, a_bits),
                        w_scales=w_scales, group_size=group_size)


def _check(a_packed, w_packed, lut_table, w_scales, w_bits, a_bits,
           group_size) -> tuple[int, int, int]:
    if (w_bits, a_bits) not in KERNEL_BITS:
        raise NotImplementedError(
            f"lut_gemm kernel: w{w_bits}a{a_bits} is not instantiated "
            f"(have {KERNEL_BITS})")
    tensors = [a_packed, w_packed, lut_table] + ([w_scales] if w_scales is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lut_gemm kernel: operands must be contiguous")
    if a_packed.dtype != torch.uint8 or w_packed.dtype != torch.uint8:
        raise TypeError("lut_gemm kernel: packed operands must be uint8")
    if lut_table.dtype != torch.float32 or lut_table.shape != (2 ** (w_bits + a_bits),):
        raise ValueError(f"lut_gemm kernel: LUT must be f32 of shape "
                         f"({2 ** (w_bits + a_bits)},), got "
                         f"{lut_table.dtype} {tuple(lut_table.shape)}")
    if a_packed.ndim != 2 or w_packed.ndim != 2:
        raise ValueError("lut_gemm kernel: operands must be 2-D")
    fw, fa = packing.PACK_FACTOR[w_bits], packing.PACK_FACTOR[a_bits]
    M, N = a_packed.shape[0], w_packed.shape[0]
    K = w_packed.shape[1] * fw
    if a_packed.shape[1] * fa != K or K % math.lcm(fw, fa):
        raise ValueError(f"lut_gemm kernel: K mismatch {tuple(a_packed.shape)} "
                         f"vs {tuple(w_packed.shape)} at w{w_bits}a{a_bits}")
    if w_scales is not None:
        if (group_size is None or group_size % math.lcm(fw, fa) or K % group_size
                or w_scales.dtype != torch.float32
                or w_scales.shape != (N, K // group_size)):
            raise ValueError(f"lut_gemm kernel: group scales {tuple(w_scales.shape)} "
                             f"do not fit K={K}, N={N}, group_size={group_size}")
    if any(t.device.type != "cuda" or t.device != a_packed.device for t in tensors):
        raise ValueError("lut_gemm kernel: every operand must be on the same "
                         "CUDA device")
    return M, N, K


def lut_gemm_cuda(a_packed, w_packed, lut_table, w_scales=None, *,
                  w_bits: int, a_bits: int, group_size=None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only)."""
    M, N, K = _check(a_packed, w_packed, lut_table, w_scales, w_bits, a_bits,
                     group_size)
    out = torch.empty((M, N), dtype=torch.float32, device=a_packed.device)
    if M == 0 or N == 0:
        return out
    lib = build.library("lut_gemm")
    stream = torch.cuda.current_stream(a_packed.device).cuda_stream
    err = lib.lut_gemm_launch(
        a_packed.data_ptr(), w_packed.data_ptr(), lut_table.data_ptr(),
        w_scales.data_ptr() if w_scales is not None else None, out.data_ptr(),
        M, N, K, w_bits, a_bits, group_size if w_scales is not None else 0,
        stream)
    build.check(err, "lut_gemm")
    lut_gemm_cuda.launches += 1
    return out


lut_gemm_cuda.launches = 0
