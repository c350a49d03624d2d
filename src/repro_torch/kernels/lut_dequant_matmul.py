"""Packed-weight dequant matmul: the CUDA kernel
(``csrc/dequant_matmul.cu``), its wrapper, and the plain PyTorch version.

Replaces ``src/repro/kernels/lut_dequant_matmul.py::dequant_matmul_pallas``.
``out = (a @ dequant(w).T) * scales`` in f32; group-wise scales (N, K/G)
fold into the dequantized weight before the contraction.

Callers go through ``kernels/registry.py``, which takes the plain version
for CPU tensors and the kernel (``dequant_matmul_cuda``, which launches or
raises) for CUDA tensors.

Bound on the H100 and design: see the notes at the top of the CUDA sources
(latency-bound at the decode shapes, multiply-add-bound at the prefill's
M 128; the tiling of ``lut_gemm.py::dense_partition``, K windows merged on
chip in a cluster; products and sums rounded in an order the plain version
repeats, ``ref.py::tile_order_matmul``).
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from . import build
from .lut_gemm import dense_partition
from .ref import tile_order_dequant_matmul

KERNEL_BITS = (2, 4)


def _partition(a, N, bits, group_size, ranks, cols):
    """The kernel's tiling of this call (its activations staged as bf16 or
    f32)."""
    M, K = a.shape
    return dense_partition(M, N, K, bits, 16 if a.dtype == torch.bfloat16 else 32,
                           group_size, ranks=ranks, cols=cols)


def dequant_matmul_plain(a, w_packed, codebook, scales, *, bits: int,
                         group_size=None, ranks=None, cols=None) -> torch.Tensor:
    """The plain PyTorch version (any device): ``ref_dequant_matmul``
    summed in the kernel's order on the kernel's tiling (``ranks`` and
    ``cols`` as the kernel takes them), so the two agree bit for bit."""
    _, _, C, kpr = _partition(a, w_packed.shape[0], bits, group_size, ranks, cols)
    return tile_order_dequant_matmul(a, w_packed, codebook, scales, bits,
                                     group_size, ranks=C, k_per_rank=kpr)


def _check(a, w_packed, codebook, scales, bits, group_size):
    if bits not in KERNEL_BITS:
        raise NotImplementedError(
            f"dequant_matmul kernel: w{bits} is not instantiated "
            f"(have {KERNEL_BITS})")
    tensors = (a, w_packed, codebook, scales)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dequant_matmul kernel: operands must be contiguous")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequant_matmul kernel: activations must be f32 or "
                        f"bf16, got {a.dtype}")
    if w_packed.dtype != torch.uint8:
        raise TypeError("dequant_matmul kernel: packed weights must be uint8")
    if codebook.dtype != torch.float32 or codebook.shape != (2 ** bits,):
        raise ValueError(f"dequant_matmul kernel: codebook must be f32 of "
                         f"shape ({2 ** bits},)")
    if a.ndim != 2 or w_packed.ndim != 2:
        raise ValueError("dequant_matmul kernel: operands must be 2-D")
    f = packing.PACK_FACTOR[bits]
    M, K = a.shape
    N = w_packed.shape[0]
    if w_packed.shape[1] * f != K:
        raise ValueError(f"dequant_matmul kernel: K mismatch {tuple(a.shape)} "
                         f"vs {tuple(w_packed.shape)} at w{bits}")
    want = (N,) if group_size is None else (N, K // group_size)
    if (scales.dtype != torch.float32 or scales.shape != want
            or (group_size is not None and (group_size % f or K % group_size))):
        raise ValueError(f"dequant_matmul kernel: scales {scales.dtype} "
                         f"{tuple(scales.shape)} do not fit K={K}, N={N}, "
                         f"group_size={group_size}")
    if any(t.device.type != "cuda" or t.device != a.device for t in tensors):
        raise ValueError("dequant_matmul kernel: every operand must be on the "
                         "same CUDA device")
    return M, N, K


def dequant_matmul_cuda(a, w_packed, codebook, scales, *, bits: int,
                        group_size=None, ranks=None, cols=None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only), on
    the tiling of ``dense_partition`` (``ranks`` and ``cols`` passed on)."""
    M, N, K = _check(a, w_packed, codebook, scales, bits, group_size)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    lib = build.library("dequant_matmul")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.dequant_matmul_launch(
        a.data_ptr(), w_packed.data_ptr(), codebook.data_ptr(),
        scales.data_ptr(), out.data_ptr(), M, N, K, bits,
        group_size or 0, int(a.dtype == torch.bfloat16),
        *_partition(a, N, bits, group_size, ranks, cols), stream)
    build.check(err, "dequant_matmul")
    dequant_matmul_cuda.launches += 1
    return out


dequant_matmul_cuda.launches = 0
