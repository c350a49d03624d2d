"""The bit-sliced LUT GEMMs: two CUDA kernels (``csrc/lut_gemm_bs_fused.cu``
and ``csrc/lut_gemm_bitsliced.cu``, one integer core in
``csrc/bs_common.cuh``), their wrappers, their plain PyTorch versions, the
tiling both kernels run on (``bs_partition``) and the kernels' walk in
torch (``lut_gemm_bitsliced_walk``, ``lut_gemm_bs_fused_walk``).

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

``bs_partition`` is the one place that chooses how the kernels cut a call:
MT rows x NT columns a block, and the C blocks of a thread-block cluster
that split K into windows of ``k_per_rank`` codes, C windows a round. It
reads static shapes only; the wrappers pass its result to the C entry
points and the walk replays the same cut.

Callers go through ``kernels/registry.py``, which takes the plain version
for CPU tensors and the kernel (``*_cuda``, which launches or raises) for
CUDA tensors.

Bound on the H100 and design: see the notes at the top of the CUDA sources.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import packing, quant
from repro_torch.device import CARD_SMS
from . import build
from .ref import _bitplane_pattern_matrix, ref_lut_gemm_bitsliced, ref_lut_gemm_bs_fused

# weight widths the CUDA sources instantiate (the plans use 2 and 4 bits)
KERNEL_BITS = (2, 4)
KERNEL_A_BITS = range(2, 9)
# the tiling of csrc/bs_common.cuh: pattern groups a 16-byte plane load
# carries (one packed 16-bit run), the row tiles (MT) and column tiles (NT,
# widest first) the sources take, the largest portable cluster, the blocks
# an SM holds at once (kBsMinBlocks), the bytes each partial buffer of a
# block may take, and the bias that keeps every packed table entry
# non-negative (4 * 128)
BS_SEG = 16
BS_ROW_TILES = (1, 4, 8)
BS_COL_TILES = (128, 64, 32)
BS_MAX_CLUSTER = 8
BS_BLOCKS_PER_SM = 3
BS_PART_BYTES = 48 * 1024
BS_BIAS = packing.BITPLANE_GROUP * 128


def bs_partition(M: int, N: int, K: int, group_size: int | None = None, *,
                 ranks: int | None = None,
                 cols: int | None = None) -> tuple[int, int, int, int]:
    """(MT, NT, C, k_per_rank): how both bit-sliced kernels cut a call. A
    block owns MT rows (1, 4 or 8) and NT columns (128, 64 or 32) of K
    windows of k_per_rank codes; the C <= 8 blocks of a column tile form a
    cluster, rank c owning windows c, c + C, c + 2C, ... (one round of C
    windows a pass, the last window ragged). A window is a whole number of
    16-group segments (64 codes) and, under group scales, of scale groups,
    so no scale group straddles two ranks. Per channel one round covers K.

    NT is 128: one table build serves the most columns, and ``bs_sweep.py``
    found it within 10% of the best (NT, C) at every qwen and tp=2 shape,
    where narrower tiles that give N = 1024 132 blocks or more ran 10-25%
    slower. C is as large as BS_BLOCKS_PER_SM blocks on every SM allow
    (every cluster resident at once), cut so that no rank is empty.
    ``ranks`` and ``cols`` ask for another C and another widest NT (the
    sweep and the tests); the cut and the narrowing below still apply.
    Under group scales a rank keeps one int32 partial per scale group of
    its window, row and column, and receives one term per scale group of
    the round for its share of the outputs: where those pass BS_PART_BYTES
    (``_partials_bytes``), NT narrows first, then C grows, then the window
    shrinks, so that small scale groups over a long K take several rounds.
    Static shapes only: choosing needs no device read."""
    if K < packing.BITPLANE_GROUP or K % packing.BITPLANE_GROUP:
        raise ValueError(f"bs_partition: K={K} is not a positive multiple of "
                         f"{packing.BITPLANE_GROUP}")
    MT = next(t for t in BS_ROW_TILES if t >= min(M, BS_ROW_TILES[-1]))
    KG = K // packing.BITPLANE_GROUP
    gpg = group_size // packing.BITPLANE_GROUP if group_size else 1
    unit = math.lcm(BS_SEG, gpg)                 # pattern groups
    units = -(-KG // unit)
    c_max = min(BS_MAX_CLUSTER, units)
    row_tiles = -(-M // MT)
    NT = cols or BS_COL_TILES[0]
    if NT not in BS_COL_TILES or (ranks is not None and not 1 <= ranks <= c_max):
        raise ValueError(f"bs_partition: cols={cols} is not one of {BS_COL_TILES}, "
                         f"or ranks={ranks} is not in 1..{c_max}")

    def cut(want: int) -> tuple[int, int]:
        per = -(-units // want) * unit
        return -(-KG // per), per

    want = ranks or max(1, min(c_max, BS_BLOCKS_PER_SM * CARD_SMS
                               // (-(-N // NT) * row_tiles)))
    C, per = cut(want)
    while _partials_bytes(MT, NT, C, per * packing.BITPLANE_GROUP,
                          group_size) > BS_PART_BYTES:
        if NT > BS_COL_TILES[-1]:
            NT //= 2
        elif ranks is None and want < c_max:
            want += 1
            C, per = cut(want)
        elif per > unit:
            per -= unit
        else:       # BS_PART_BYTES holds a window of one unit (<= 16 scale groups)
            raise ValueError(f"bs_partition: {BS_PART_BYTES} bytes do not hold "
                             f"the partials of one {unit * packing.BITPLANE_GROUP}"
                             f"-code window")
    return MT, NT, C, per * packing.BITPLANE_GROUP


def bs_rounds(K: int, C: int, k_per_rank: int) -> int:
    """The rounds of C windows a tiling of ``bs_partition`` walks K in."""
    return -(-K // (C * k_per_rank))


def _partials_bytes(MT: int, NT: int, C: int, k_per_rank: int,
                    group_size: int | None) -> int:
    """The larger of a block's two partial buffers (csrc/bs_common.cuh
    bs_layout): under group scales its rank's int32 partials (one per scale
    group of the window, row and column), and what the ranks send it in a
    round for its share of the outputs (one sum each, or one term per scale
    group of the round's C windows)."""
    share = -(-MT * NT // C)
    if group_size is None:
        return share * 4
    return max(MT * NT, C * share) * (k_per_rank // group_size) * 4


def lut_gemm_bitsliced_walk(a_codes, w_planes, w_scales=None, *, bits: int,
                            group_size=None, ranks=None, cols=None) -> torch.Tensor:
    """The kernels' integer walk in torch, for the CPU tests: K cut into the
    windows of ``bs_partition`` (``ranks`` and ``cols`` passed on), the
    16-entry tables biased by BS_BIAS, each plane's lookups summed in 16-bit
    lanes (wrap-around emulated, as the packed 32-bit adds would wrap) over
    runs that end at every 16-group segment and, under group scales, every
    scale group, then widened into int32; per channel the windows' partials
    summed and converted, grouped each scale group's exact partial
    converted, scaled and added in ascending group order over the windows
    (the kernels' rounds). Any device."""
    M, K = a_codes.shape
    N = w_planes.shape[1]
    _, _, C, kpr = bs_partition(M, N, K, group_size, ranks=ranks, cols=cols)
    G = packing.BITPLANE_GROUP
    KG, kgpr = K // G, kpr // G
    windows = C * bs_rounds(K, C, kpr)
    dev = a_codes.device
    # zero codes and patterns past K, as the kernels' padded tables read them
    pad = windows * kgpr - KG
    a = torch.nn.functional.pad(a_codes.reshape(M, KG, G).to(torch.int32),
                                (0, 0, 0, pad))
    pat_bits = _bitplane_pattern_matrix(dev).int()
    lut = (a[..., None] * pat_bits).sum(-2, dtype=torch.int32) + BS_BIAS
    pats = torch.nn.functional.pad(w_planes.long() & (2 ** G - 1), (0, pad))
    coefs = packing.bitplane_coeffs(bits)
    kg = torch.arange(windows * kgpr, device=dev)
    if group_size is None:
        run = kg // BS_SEG
    else:                      # runs also end at scale-group ends
        gpg = group_size // G
        ends = ((kg + 1) % BS_SEG == 0) | ((kg + 1) % gpg == 0)
        run = torch.cumsum(ends.long(), 0) - ends.long()
    n_runs = int(run[-1]) + 1
    lengths = torch.bincount(run, minlength=n_runs)
    widened = lengths.int() * BS_BIAS              # - n * bias * sum(coefs), sum = -1
    widened = widened.expand(M, N, n_runs).clone()
    for p, coef in enumerate(coefs):
        e = torch.gather(lut[:, None].expand(M, N, -1, -1), 3,
                         pats[p][None, :, :, None].expand(M, -1, -1, 1))[..., 0]
        lanes = torch.zeros((M, N, n_runs), dtype=torch.int32, device=dev)
        lanes.index_add_(2, run, e)
        widened += coef * (lanes & 0xFFFF)
    if group_size is None:
        per_window = widened.reshape(M, N, windows, -1).sum(-1, dtype=torch.int32)
        return per_window.sum(-1, dtype=torch.int32).to(torch.float32)
    group_of_run = torch.zeros(n_runs, dtype=torch.long, device=dev)
    group_of_run[run] = kg // gpg
    n_groups = KG // gpg
    part = torch.zeros((M, N, windows * kgpr // gpg), dtype=torch.int32, device=dev)
    part.index_add_(2, group_of_run, widened)
    part = part[..., :n_groups].to(torch.float32) * w_scales[None].float()
    out = torch.zeros((M, N), dtype=torch.float32, device=dev)
    for g in range(n_groups):
        out = out + part[..., g]
    return out


def lut_gemm_bs_fused_walk(x, w_planes, w_scales, a_sc=None, *, w_bits: int,
                           a_bits: int = 8, group_size=None, ranks=None,
                           cols=None) -> torch.Tensor:
    """The fused kernel in torch: the plain version's quantization (the
    ranks' maxima merge exactly), ``lut_gemm_bitsliced_walk`` on the codes,
    and the epilogue in the kernel's order. Any device."""
    if a_sc is None:
        a_scale, _ = quant.compute_scale_zero_point(x, a_bits, signed=True, axis=0)
    else:
        a_scale = a_sc
    aq = quant.quantize(x, a_scale, bits=a_bits, signed=True)
    y = lut_gemm_bitsliced_walk(aq, w_planes, w_scales if group_size else None,
                                bits=w_bits, group_size=group_size,
                                ranks=ranks, cols=cols)
    if group_size is None:
        y = y * w_scales[None, :]
    return y * a_scale


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
                           a_bits: int = 8, group_size=None, ranks=None,
                           cols=None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only), on
    the tiling of ``bs_partition`` (``ranks`` and ``cols`` passed on: the
    sweep of ``bs_sweep.py`` and the tests)."""
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
        *bs_partition(M, N, K, group_size, ranks=ranks, cols=cols), stream)
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
                            a_bits: int = 8, group_size=None, ranks=None,
                            cols=None) -> torch.Tensor:
    """Launch the two-step CUDA kernel on the current stream (CUDA tensors
    only), on the tiling of ``bs_partition`` (``ranks`` and ``cols`` passed
    on)."""
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
        M, N, K, w_bits, group_size or 0,
        *bs_partition(M, N, K, group_size, ranks=ranks, cols=cols), stream)
    build.check(err, "lut_gemm_bitsliced")
    lut_gemm_bitsliced_cuda.launches += 1
    return out


lut_gemm_bitsliced_cuda.launches = 0


def bs_active_clusters(op: str, M: int, N: int, K: int, bits: int,
                       group_size=None, *, ranks=None, cols=None) -> tuple[tuple, int]:
    """(the tiling, clusters the card holds at once) for ``op``
    (``lut_gemm_bs_fused`` with bf16 x and dynamic scales, or
    ``lut_gemm_bitsliced``) at these shapes: ``cudaOccupancyMaxActiveClusters``
    of the launch on ``bs_partition``'s tiling. Builds the library."""
    part = bs_partition(M, N, K, group_size, ranks=ranks, cols=cols)
    lib = build.library(op)
    if op == "lut_gemm_bs_fused":
        n = lib.lut_gemm_bs_fused_active_clusters(M, N, K, bits, 8, group_size or 0,
                                                  1, 0, *part)
    else:
        n = lib.lut_gemm_bitsliced_active_clusters(M, N, K, bits, group_size or 0,
                                                   *part)
    if n < 0:
        build.check(-n, f"{op} occupancy query")
    return part, n
