"""Product-LUT GEMM: the CUDA kernel (``csrc/lut_gemm.cu``), its wrapper,
and the plain PyTorch version.

Replaces ``src/repro/kernels/lut_gemm.py::lut_gemm_pallas``.
``out[m, n] = sum_k LUT[(w[n, k] << a_bits) | a[m, k]]`` in f32, with an
optional group-scale epilogue ``sum_g s[n, g] * sum_{k in g} LUT[...]``.
Weights may be packed under scheme 'a', 'c' or 'd' (the same bytes).

Callers go through ``kernels/registry.py``, which takes the plain version
for CPU tensors and the kernel (``lut_gemm_cuda``, which launches or
raises) for CUDA tensors. With a float table (k-means levels) the plain
version replays the kernel's walk per channel
(``ref.py::tile_order_lut_gemm``), so the two agree bit for bit, as an
integer table's sums do in any order.

``dense_partition`` is the one place that chooses how this kernel and
``dequant_matmul``'s (``csrc/dense_common.cuh``) cut a call: MT rows x NT
columns a block, and the C blocks of a thread-block cluster that split K
into windows of ``k_per_rank`` codes; ``expert_partition`` does the same
for the two expert GEMMs (``kernels/expert_gemm.py``), which walk the same
tiles with an expert axis. They read static shapes only; the wrappers
pass their result to the C entry points, and the dequant kernels' plain
versions replay the same cut (``ref.py::tile_order_matmul``).

Bound on the H100 and design: see the notes at the top of the CUDA sources
(latency-bound at the decode shapes, table-read-bound at the prefill's
M 128; wide column tiles, K windows merged on chip in a cluster, every load
of a window issued before the first lookup, the table transposed in shared
memory).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import packing
from repro_torch.core.lut import ProductLUT
from repro_torch.device import CARD_SMS
from . import build
from .ref import DENSE_LANES, ref_lut_gemm, tile_order_lut_gemm

# (w_bits, a_bits) pairs the CUDA source instantiates
KERNEL_BITS = ((2, 2), (2, 8), (4, 4), (4, 8))

# the tiling of csrc/dense_common.cuh: rows a tile at most (kMaxMt), the
# column tiles (NT = 32 x columns a thread), the largest portable cluster,
# the weight bytes a block stages a round (kWTileBytes: 8 16-byte pieces a
# thread), and the budgets of its activation and scale tiles
DENSE_ROW_TILE = 8
DENSE_COL_TILES = (128, 64)
DENSE_MAX_CLUSTER = 8
# decode (one tile of at most 4 rows): K windows of about this many codes,
# on at most this many ranks (the fastest tilings of bs_sweep.py's sweep on
# an H100 at qwen1.5-0.5b's shapes)
DENSE_DECODE_WINDOW = 256
DENSE_DECODE_RANKS = 6
DENSE_W_TILE_BYTES = 32 * 1024
DENSE_A_TILE_BYTES = 32 * 1024
DENSE_S_TILE_BYTES = 24 * 1024


def dense_unit(w_bits: int) -> int:
    """Codes of one window unit: one 4-byte weight word for each of the
    DENSE_LANES k-lanes (128 codes at 2 bits, 64 at 4)."""
    return DENSE_LANES * 32 // w_bits


def dense_partition(M: int, N: int, K: int, w_bits: int, a_bits: int,
                    group_size: int | None = None, *, ranks: int | None = None,
                    cols: int | None = None) -> tuple[int, int, int, int]:
    """(MT, NT, C, k_per_rank): how ``lut_gemm`` and ``dequant_matmul`` cut
    a call. A block owns MT rows (at most 8, the rows spread evenly over the
    row tiles) and NT columns (128 or 64) of K windows of k_per_rank codes
    (whole window units, ``dense_unit``); the C <= 8 blocks of a column
    tile form a cluster, rank c owning windows c, c + C, c + 2C, ... (rounds
    of C windows, the last window ragged). ``a_bits`` is the bits of one
    activation as the kernel stages it: the packed code width for
    ``lut_gemm``, 16 or 32 for ``dequant_matmul``'s bf16 or f32 rows.

    The rules come from ``bs_sweep.py``'s sweep of every (NT, C) on an H100.
    Decode (one row tile of at most 4 rows) takes NT 64 and windows of
    about DENSE_DECODE_WINDOW codes on at most DENSE_DECODE_RANKS ranks:
    wider clusters lost more to the merge than they gained in parallel
    loads. More rows take NT 64 while the 64-column tiles stay within two
    blocks an SM (else 128), and C as large as one block an SM allows, or
    as large as one round of windows needs while the blocks stay within
    two an SM. C is cut so that no rank is empty. A window is as long as
    that C needs, but no longer than the block's tiles allow (the weight
    tile DENSE_W_TILE_BYTES, the MT activation rows DENSE_A_TILE_BYTES,
    the group scales DENSE_S_TILE_BYTES): past that, K takes several
    rounds. ``ranks`` and ``cols`` ask for another C and NT (the sweep and
    the tests); the cut still applies. Static shapes only: choosing needs
    no device read."""
    return expert_partition(1, M, N, K, w_bits, a_bits, group_size, ranks=ranks, cols=cols)


def expert_partition(E: int, M: int, N: int, K: int, w_bits: int, a_bits: int,
                     group_size: int | None = None, *, ranks: int | None = None,
                     cols: int | None = None) -> tuple[int, int, int, int]:
    """(MT, NT, C, k_per_rank): how ``expert_dequant_matmul`` and
    ``expert_lut_gemm`` cut a call of E experts, each an (M, K) x (N, K)
    product on the tiles of ``dense_partition`` (``a_bits`` as there: the
    packed code width, or 16 / 32 for bf16 / f32 rows). The tiles that fill
    the card are counted over every expert, E x ceil(N / NT) x row tiles:
    with many experts C is 1 and a block walks its column tile's whole K in
    one window where the tiles allow (at moonshot-v1-16b-a3b's decode
    shape, w2: 64 columns x 2048 codes, one DRAM round trip a block, no
    cluster merge). One tile of at most 4 rows takes NT 64, the widest
    window. One expert is ``dense_partition``'s call. ``ranks`` and
    ``cols`` as there; static shapes only."""
    if min(E, M, N, K) < 1:
        raise ValueError(f"partition: E={E}, M={M}, N={N}, K={K} must be positive")
    unit = dense_unit(w_bits)
    row_tiles = -(-M // DENSE_ROW_TILE)
    MT = -(-M // row_tiles)
    units = -(-K // unit)
    c_max = min(DENSE_MAX_CLUSTER, units)
    small = row_tiles == 1 and MT <= 4            # one tile of at most 4 rows
    decode = small and E == 1
    wide, narrow = DENSE_COL_TILES
    NT = cols or (wide if not small and E * -(-N // narrow) * row_tiles > 2 * CARD_SMS
                  else narrow)
    if NT not in DENSE_COL_TILES or (ranks is not None and not 1 <= ranks <= c_max):
        raise ValueError(f"partition: cols={cols} is not one of {DENSE_COL_TILES}, "
                         f"or ranks={ranks} is not in 1..{c_max}")
    cap = min(DENSE_W_TILE_BYTES * 8 // (NT * w_bits),
              DENSE_A_TILE_BYTES * 8 // (MT * a_bits))
    if group_size:       # ceil(window / G) + 1 groups a window touches
        cap = min(cap, (DENSE_S_TILE_BYTES // (NT * 4) - 2) * group_size)
    if cap < unit and cols is None and group_size:      # small groups: narrower tiles
        NT = DENSE_COL_TILES[-1]
        cap = min(cap, (DENSE_S_TILE_BYTES // (NT * 4) - 2) * group_size)
    if cap < unit:
        raise ValueError(f"partition: no {unit}-code window fits the tiles "
                         f"(NT={NT}, group_size={group_size})")
    tiles = E * -(-N // NT) * row_tiles
    if ranks:
        want = ranks
    elif decode:
        want = min(c_max, DENSE_DECODE_RANKS, -(-K // DENSE_DECODE_WINDOW))
    else:
        want = max(1, min(c_max, CARD_SMS // tiles))
        one_round = -(-units // (cap // unit))       # ranks for a single round
        if want < one_round <= c_max and tiles * one_round <= 2 * CARD_SMS:
            want = one_round
    per = min(cap // unit, -(-units // want))
    C = min(want, -(-units // per))
    return MT, NT, C, per * unit


def dense_rounds(K: int, C: int, k_per_rank: int) -> int:
    """The rounds of C windows a tiling of ``dense_partition`` walks K in."""
    return -(-K // (C * k_per_rank))


def dense_active_clusters(op: str, M: int, N: int, K: int, w_bits: int, a_bits: int,
                          group_size=None, *, ranks=None, cols=None) -> tuple[tuple, int]:
    """(the tiling, clusters the card holds at once) for ``op``
    (``lut_gemm``, or ``dequant_matmul`` with bf16 activations: a_bits 16)
    at these shapes: ``cudaOccupancyMaxActiveClusters`` of the launch on
    ``dense_partition``'s tiling. Builds the library."""
    part = dense_partition(M, N, K, w_bits, a_bits, group_size, ranks=ranks, cols=cols)
    lib = build.library(op)
    if op == "lut_gemm":
        n = lib.lut_gemm_active_clusters(M, N, K, w_bits, a_bits, group_size or 0, *part)
    else:
        n = lib.dequant_matmul_active_clusters(M, N, K, w_bits, group_size or 0, *part)
    if n < 0:
        build.check(-n, f"{op} occupancy query")
    return part, n


def lut_gemm_plain(a_packed, w_packed, lut_table, w_scales=None, *,
                   w_bits: int, a_bits: int, group_size=None, ranks=None,
                   cols=None, float_table: bool = False) -> torch.Tensor:
    """The plain PyTorch version (any device). An integer table (every
    uniform codebook's) sums exactly in any order: ``ref_lut_gemm``.
    ``float_table`` (a k-means leaf's table, ``QuantizedWeight.nonuniform``)
    rounds its sums, so then it sums per channel in the kernel's walk order
    on the kernel's tiling (``ranks`` and ``cols`` as the kernel takes
    them; ``ref.py::tile_order_lut_gemm``), and the two agree bit for bit.
    Grouped, the kernel scales each partial in a fused multiply-add; that
    path is ``ref_lut_gemm``, held to a tolerance (a k-means leaf has no
    groups)."""
    if not float_table or w_scales is not None:
        return ref_lut_gemm(a_packed, w_packed, ProductLUT(lut_table, w_bits, a_bits),
                            w_scales=w_scales, group_size=group_size)
    M, N = a_packed.shape[-2], w_packed.shape[-2]
    K = w_packed.shape[-1] * packing.PACK_FACTOR[w_bits]
    _, _, C, kpr = dense_partition(M, N, K, w_bits, a_bits, None, ranks=ranks, cols=cols)
    return tile_order_lut_gemm(a_packed, w_packed, lut_table, w_bits=w_bits,
                               a_bits=a_bits, ranks=C, k_per_rank=kpr)


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
                  w_bits: int, a_bits: int, group_size=None, ranks=None,
                  cols=None, float_table: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (CUDA tensors only), on
    the tiling of ``dense_partition`` (``ranks`` and ``cols`` passed on: the
    sweep of ``bs_sweep.py`` and the tests). ``float_table`` tells the plain
    version how to sum; the kernel walks any table alike."""
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
        *dense_partition(M, N, K, w_bits, a_bits,
                         group_size if w_scales is not None else None,
                         ranks=ranks, cols=cols), stream)
    build.check(err, "lut_gemm")
    lut_gemm_cuda.launches += 1
    return out


lut_gemm_cuda.launches = 0
