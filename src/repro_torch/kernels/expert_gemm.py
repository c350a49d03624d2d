"""Per-expert packed-weight GEMMs: the CUDA kernels (``csrc/expert_gemm.cu``),
their wrappers, and the plain PyTorch versions.

Replace ``src/repro/kernels/expert_dequant_matmul.py``'s
``expert_dequant_matmul_pallas`` and ``expert_lut_gemm_pallas``:

  expert_dequant_matmul  out[e] = (x[e] @ dequant(w[e]).T) * scales[e], f32;
                         x (E, M, K) bf16/f32, w (E, N, K/f) uint8, a 2^b
                         codebook, scales (E, N) or (E, N, K/G) folded into
                         the weight before the contraction
  expert_lut_gemm        out[e, m, n] = sum_k LUT[(w[e,n,k] << b) | a[e,m,k]],
                         f32; packed activation and weight codes of the same
                         width b, a 2^(2b) product LUT, optional (E, N, K/G)
                         group scales applied per K-group; per-channel and
                         activation scales stay in the caller

Both take ``active`` (E,), bool or uint8, or None: where it is given, the
experts whose flag is 0 (no token was dispatched to them) come out zero
and the kernels load none of their weights; None computes every expert.
``moe_apply`` passes the flag its dispatch computed, which leaves its
result as it is (an empty expert's rows are zero and come out zero).

Callers go through ``kernels/registry.py``, which takes the plain version
for CPU tensors and the kernel (``*_cuda``, which launches or raises) for
CUDA tensors.

Bound on the H100 and design: see the note at the top of the CUDA source
(the tiled walk of ``csrc/dense_common.cuh`` with an expert axis, tiled by
``lut_gemm.py::expert_partition``).
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.lut import ProductLUT
from . import build
from .lut_gemm import expert_partition
from .ref import ref_expert_lut_gemm, tile_order_dequant_matmul

KERNEL_BITS = (2, 4)


def _dequant_partition(x, N, bits, group_size, ranks, cols):
    """The dequant kernel's tiling of this call (its activations staged as
    bf16 or f32)."""
    E, M, K = x.shape
    return expert_partition(E, M, N, K, bits, 16 if x.dtype == torch.bfloat16 else 32,
                            group_size, ranks=ranks, cols=cols)


def _only_active(out, active):
    """``out`` with the experts whose flag is 0 set to zero, as the kernels
    write them."""
    if active is None:
        return out
    return torch.where(active.reshape(-1, 1, 1).bool(), out, 0.0)


def expert_active_clusters(op: str, E: int, M: int, N: int, K: int, w_bits: int,
                           a_bits: int, group_size=None, *, ranks=None,
                           cols=None) -> tuple[tuple, int]:
    """(the tiling, clusters the card holds at once) for ``op``
    (``expert_lut_gemm``, or ``expert_dequant_matmul`` with bf16
    activations: a_bits 16) at these shapes: ``cudaOccupancyMaxActiveClusters``
    of the launch on ``expert_partition``'s tiling (blocks at C 1). Builds
    the library."""
    part = expert_partition(E, M, N, K, w_bits, a_bits, group_size, ranks=ranks, cols=cols)
    lib = build.library("expert_gemm")
    query = (lib.expert_lut_gemm_active_clusters if op == "expert_lut_gemm"
             else lib.expert_dequant_matmul_active_clusters)
    n = query(E, M, N, K, w_bits, group_size or 0, *part)
    if n < 0:
        build.check(-n, f"{op} occupancy query")
    return part, n


def expert_dequant_matmul_plain(x, w_packed, codebook, scales, *, bits: int,
                                group_size=None, active=None, ranks=None,
                                cols=None) -> torch.Tensor:
    """The plain PyTorch version (any device): ``ref_expert_dequant_matmul``
    summed in the kernel's order on the kernel's tiling (``ranks`` and
    ``cols`` as the kernel takes them), every expert at once, so the two
    agree bit for bit."""
    E, M, K = x.shape
    N = w_packed.shape[1]
    if min(E, M, N, K) == 0:
        return torch.zeros((E, M, N), dtype=torch.float32, device=x.device)
    _, _, C, kpr = _dequant_partition(x, N, bits, group_size, ranks, cols)
    out = tile_order_dequant_matmul(x, w_packed, codebook, scales, bits, group_size,
                                    ranks=C, k_per_rank=kpr)
    return _only_active(out, active)


def expert_lut_gemm_plain(a_packed, w_packed, lut_table, w_scales=None, *,
                          w_bits: int, a_bits: int, scheme: str = "d",
                          group_size=None, active=None) -> torch.Tensor:
    """The plain PyTorch version (any device). Schemes 'a', 'c' and 'd'
    store the same bytes, so ``scheme`` changes nothing here."""
    del scheme
    out = ref_expert_lut_gemm(a_packed, w_packed, ProductLUT(lut_table, w_bits, a_bits),
                              w_scales=w_scales, group_size=group_size)
    return _only_active(out, active)


def _common(what, tensors, bits, w_packed):
    if bits not in KERNEL_BITS:
        raise NotImplementedError(f"{what} kernel: w{bits} is not instantiated "
                                  f"(have {KERNEL_BITS})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel: operands must be contiguous")
    if w_packed.dtype != torch.uint8 or w_packed.ndim != 3:
        raise TypeError(f"{what} kernel: packed weights must be uint8 (E, N, K/f)")
    if any(t.device.type != "cuda" or t.device != w_packed.device for t in tensors):
        raise ValueError(f"{what} kernel: every operand must be on the same "
                         "CUDA device")


def _check_scales(what, scales, E, N, K, f, group_size):
    want = (E, N) if group_size is None else (E, N, K // group_size)
    if group_size is not None and (group_size % f or K % group_size):
        raise ValueError(f"{what} kernel: group_size {group_size} does not fit "
                         f"K={K} at {8 // f}-code bytes")
    if scales.dtype != torch.float32 or scales.shape != want:
        raise ValueError(f"{what} kernel: scales {scales.dtype} "
                         f"{tuple(scales.shape)} do not fit E={E}, N={N}, "
                         f"K={K}, group_size={group_size}")


def _check_active(what, active, E, device):
    if active is None:
        return None
    if (active.dtype not in (torch.bool, torch.uint8) or active.shape != (E,)
            or not active.is_contiguous() or active.device != device):
        raise ValueError(f"{what} kernel: active must be a contiguous bool or uint8 "
                         f"({E},) tensor on {device}, got {active.dtype} "
                         f"{tuple(active.shape)} on {active.device}")
    return active.data_ptr()


def _launch(fn, out, *args):
    """Call a C entry point on the current stream; raise on its error."""
    err = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    build.check(err, fn.__name__)


def expert_dequant_matmul_cuda(x, w_packed, codebook, scales, *, bits: int,
                               group_size=None, active=None, ranks=None,
                               cols=None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only), on
    the tiling of ``expert_partition`` (``ranks`` and ``cols`` passed on:
    the sweep of ``bs_sweep.py`` and the tests)."""
    what = "expert_dequant_matmul"
    _common(what, (x, w_packed, codebook, scales), bits, w_packed)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel: activations must be f32 or bf16, got "
                        f"{x.dtype}")
    if codebook.dtype != torch.float32 or codebook.shape != (2 ** bits,):
        raise ValueError(f"{what} kernel: codebook must be f32 of shape "
                         f"({2 ** bits},)")
    f = packing.PACK_FACTOR[bits]
    if x.ndim != 3 or x.shape[0] != w_packed.shape[0] \
            or w_packed.shape[2] * f != x.shape[2]:
        raise ValueError(f"{what} kernel: shapes {tuple(x.shape)} and "
                         f"{tuple(w_packed.shape)} do not fit (E, M, K) x "
                         f"(E, N, K/{f})")
    E, M, K = x.shape
    N = w_packed.shape[1]
    _check_scales(what, scales, E, N, K, f, group_size)
    flags = _check_active(what, active, E, x.device)
    if min(E, M, N, K) == 0:
        return torch.zeros((E, M, N), dtype=torch.float32, device=x.device)
    out = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    lib = build.library("expert_gemm")
    _launch(lib.expert_dequant_matmul_launch, out, x.data_ptr(),
            w_packed.data_ptr(), codebook.data_ptr(), scales.data_ptr(),
            out.data_ptr(), flags, E, M, N, K, bits, group_size or 0,
            int(x.dtype == torch.bfloat16),
            *_dequant_partition(x, N, bits, group_size, ranks, cols))
    expert_dequant_matmul_cuda.launches += 1
    return out


def expert_lut_gemm_cuda(a_packed, w_packed, lut_table, w_scales=None, *,
                         w_bits: int, a_bits: int, scheme: str = "d",
                         group_size=None, active=None, ranks=None,
                         cols=None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only), on
    the tiling of ``expert_partition`` (``ranks`` and ``cols`` passed on)."""
    what = "expert_lut_gemm"
    tensors = [a_packed, w_packed, lut_table] + (
        [w_scales] if w_scales is not None else [])
    _common(what, tensors, w_bits, w_packed)
    if a_bits != w_bits or scheme not in ("a", "c", "d"):
        raise NotImplementedError(f"{what} kernel: w{w_bits}a{a_bits} scheme "
                                  f"{scheme!r}; it takes w_bits == a_bits and "
                                  "the natural byte layout (schemes a, c, d)")
    if a_packed.dtype != torch.uint8 or a_packed.ndim != 3:
        raise TypeError(f"{what} kernel: packed activations must be uint8 "
                        "(E, M, K/f)")
    if lut_table.dtype != torch.float32 or lut_table.shape != (2 ** (2 * w_bits),):
        raise ValueError(f"{what} kernel: LUT must be f32 of shape "
                         f"({2 ** (2 * w_bits)},), got {lut_table.dtype} "
                         f"{tuple(lut_table.shape)}")
    if a_packed.shape[0] != w_packed.shape[0] or a_packed.shape[2] != w_packed.shape[2]:
        raise ValueError(f"{what} kernel: shapes {tuple(a_packed.shape)} and "
                         f"{tuple(w_packed.shape)} do not fit (E, M, K/f) x "
                         "(E, N, K/f)")
    f = packing.PACK_FACTOR[w_bits]
    E, M, kp = a_packed.shape
    N, K = w_packed.shape[1], kp * f
    if w_scales is not None or group_size is not None:
        if w_scales is None or group_size is None:
            raise ValueError(f"{what} kernel: group scales and group_size go "
                             "together")
        _check_scales(what, w_scales, E, N, K, f, group_size)
    flags = _check_active(what, active, E, a_packed.device)
    if min(E, M, N, K) == 0:
        return torch.zeros((E, M, N), dtype=torch.float32, device=a_packed.device)
    out = torch.empty((E, M, N), dtype=torch.float32, device=a_packed.device)
    lib = build.library("expert_gemm")
    _launch(lib.expert_lut_gemm_launch, out, a_packed.data_ptr(),
            w_packed.data_ptr(), lut_table.data_ptr(),
            w_scales.data_ptr() if w_scales is not None else None,
            out.data_ptr(), flags, E, M, N, K, w_bits,
            group_size if w_scales is not None else 0,
            *expert_partition(E, M, N, K, w_bits, a_bits, group_size,
                              ranks=ranks, cols=cols))
    expert_lut_gemm_cuda.launches += 1
    return out


expert_dequant_matmul_cuda.launches = 0
expert_lut_gemm_cuda.launches = 0
