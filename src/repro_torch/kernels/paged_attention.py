"""Paged decode attention over the packed KV pool: the CUDA kernels
(``csrc/paged_attention.cu``), their wrappers, and the plain PyTorch
versions.

Replaces ``src/repro/kernels/paged_attention.py``: ``paged_attention_pallas``
(one pass over each sequence's block table) and
``paged_attention_splitkv_pallas`` (the table walked in ``kv_splits``
chunks, each folded into unnormalised (acc, m, l) partials, then merged
exactly by ``merge_splitkv_partials``). One query row per sequence and KV
head group: q (B, KV, G, hd) bf16/f32 against int8 codes (n_blocks, bs,
KV, hd) or 4-bit codes (n_blocks, bs, KV, hd/2) u8 (low nibble first) with
(n_blocks, bs, KV) f32 scales, block tables (B, nb) and lengths (B,);
out (B, KV, G, hd) f32, rows >= lengths[b] masked. A local (sliding-window)
layer passes its ``window``: rows below lengths[b] - window are masked too,
the reference's t > pos - window with pos = lengths[b] - 1 (its engine
masks a gathered view in jnp, src/repro/models/layers.py:556-557 and
:589-591; its Pallas kernels take no window).

Three formulations live here:
  ``*_plain``            the oracles of ``kernels/ref.py``: gather a dense
                         view and take a masked softmax (the CPU path, and
                         what the card's kernels are held against)
  ``paged_attention_walk`` the kernels' own walk in torch: tiles of
                         ``KERNEL_TILE`` tokens with a running (m, l, acc)
                         over chunks of the table, the chunks of a cluster
                         merged in rank order, then the clusters' exact
                         merge. The split's chunks are ns = min(kv_splits,
                         nb) of nbc = ceil(nb / ns) entries, one rank each,
                         in the clusters of ``split_clusters``; the single
                         pass's are the C ranks of its one cluster, from
                         ``cluster_ranks`` over ``walk_extent`` rows from
                         the window's base (0 on a global layer). Each
                         stops at lengths[b] instead of the reference's
                         null-padded tail, and on a local layer starts at
                         the window's tile and masks the rows below it
  ``*_cuda``             the kernel wrappers; each launches or raises

``cluster_ranks`` is the one place that chooses how many ranks C the
single-pass kernels (this one and ``kv_cache_attention``) split a walk
into, and ``split_clusters`` how the split groups its chunks into
clusters; both read static shapes only, so no decode step waits on the
device to choose them.

A ring-paged local layer (``Engine(ring=True)``) passes its slot's ring
of ring_len blocks as a table of the same width nb as without the ring,
entry j being ring block j % ring_len (``serving/cache.py::ring_abs_row``).
Every formulation here reads only rows [lengths[b] - window, lengths[b]),
which the ring holds, so ``walk_extent``, ``cluster_ranks`` and
``split_partition`` see the nb they see without the ring and the output is
that call's, bit for bit; nothing here knows of rings.

Callers go through ``kernels/registry.py``. Where lengths[b] is 0 the
oracle averages every row of the table (softmax of all-masked scores);
the kernels and the walk read no row and return 0 there. The engine
never passes a length of 0.

Bound on the H100 and design: see the notes at the top of the CUDA source
and of ``csrc/attn_common.cuh``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import CARD_SMS
from . import build
from .ref import dequant_kv_tile, ref_paged_attention, ref_paged_attention_splitkv

_NEG = -1e30
# tokens per tile of the kernels' walk (csrc/paged_attention.cu kTile)
KERNEL_TILE = 128
# what the CUDA source takes (and block sizes that are powers of two); 120
# runs as 128 with zero padding dims, for int8 only (``check_operands``)
KERNEL_HEAD_DIMS = (16, 32, 64, 120, 128, 256)
KERNEL_MAX_G = 8
POOL_DTYPE = {8: torch.int8, 4: torch.uint8}
# the single-pass kernels' cluster split (over device.CARD_SMS SMs): the
# largest cluster (csrc/attn_common.cuh kMaxCluster; above 8 a non-portable
# size), the blocks an SM should hold at once (G == 1 / G > 1), and the
# fewest tiles a rank should walk. Above hd 128 (hd 256: a block's ring of
# two 128-row stages takes 130 KB of shared memory) an SM holds one block,
# and a cluster keeps to the portable 8 ranks; WIDE_RESIDENT[C - 1] is how
# many clusters of C such blocks the card holds at once
# (cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3 at hd 256:
# clusters sit inside one GPC, so C x that stays below the 132 SMs)
MAX_CLUSTER = 16
BLOCKS_PER_SM = (3, 2)
WIDE_HD = 128
WIDE_MAX_CLUSTER = 8
WIDE_RESIDENT = (132, 66, 39, 30, 22, 17, 15, 15)
MIN_RANK_TILES = 2
# the engine's kv_splits "auto" (auto_kv_splits): the split from
# AUTO_SPLIT_ROWS rows of max_len on, for up to AUTO_SPLIT_HEADS (sequence,
# KV head) walks, in AUTO_SPLITS chunks
AUTO_SPLIT_ROWS = 32768
AUTO_SPLIT_HEADS = 64
AUTO_SPLITS = 24


def merge_splitkv_partials(o: torch.Tensor, m: torch.Tensor,
                           l: torch.Tensor) -> torch.Tensor:
    """Exact merge of per-chunk online-softmax partials over split axis 1
    (reference paged_attention.py:151-174): ``o`` (B, ns, KV, G, hd) sums
    of exp(s - m) v, ``m`` / ``l`` (B, ns, KV, G) chunk max and sum of
    exp. out = sum_c e^(m_c - M) o_c / sum_c e^(m_c - M) l_c, M = max_c m_c.
    An all-masked chunk carries m = -1e30 and weighs exactly 0."""
    M = m.amax(dim=1)
    w = torch.exp(m - M[:, None])
    num = (o * w[..., None]).sum(dim=1)
    den = (l * w).sum(dim=1)
    return num / torch.clamp(den, min=1e-30)[..., None]


def paged_attention_plain(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths,
                          *, bits: int, window: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version (any device): the reference's oracle."""
    return ref_paged_attention(q, k_pool, k_sc, v_pool, v_sc, block_tables,
                               lengths, bits, window)


def paged_attention_splitkv_plain(q, k_pool, k_sc, v_pool, v_sc, block_tables,
                                  lengths, *, bits: int, kv_splits: int,
                                  window: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version (any device): the reference's oracle."""
    return ref_paged_attention_splitkv(q, k_pool, k_sc, v_pool, v_sc,
                                       block_tables, lengths, bits,
                                       kv_splits=kv_splits, window=window)


def kernel_head_dim(hd: int) -> int:
    """The head dim the kernels compile for ``hd``: the next power of two
    (120 runs as 128, its pad dims zero)."""
    return 1 << (int(hd) - 1).bit_length()


def max_cluster(hd: int) -> int:
    """The largest cluster the walk takes at head dim ``hd``."""
    return WIDE_MAX_CLUSTER if hd > WIDE_HD else MAX_CLUSTER


def walk_extent(nb: int, bs: int, window: Optional[int] = None) -> int:
    """The rows the single pass's ranks cover: the table's nb * bs, or on a
    local layer the rows a window can reach from its base (lo rounded down
    to a multiple of max(KERNEL_TILE, bs)): at most window + step - 1."""
    if window is None:
        return nb * bs
    return min(nb * bs, int(window) + max(KERNEL_TILE, bs) - 1)


def split_partition(nb: int, kv_splits: int) -> tuple[int, int]:
    """(ns, nbc): the number of chunks and the table entries per chunk."""
    ns = max(1, min(int(kv_splits), nb))
    return ns, -(-nb // ns)


def split_clusters(ns: int, G: int, hd: int, bits: int) -> tuple[int, int]:
    """(K, C): the split's ns chunks of a (sequence, KV head), one rank
    each, form K clusters of C ranks, C <= MAX_CLUSTER: one cluster up to
    MAX_CLUSTER chunks (merged on chip, one launch), else K =
    ceil(ns / MAX_CLUSTER) clusters of near-equal size (the first ns % K
    take ns // K + 1 chunks, the others ns // K; C = ceil(ns / K)), whose
    partials a second pass merges. Static shapes only; G and bits leave
    the rule unchanged, since ``cudaOccupancyMaxActiveClusters`` holds at
    least one cluster of MAX_CLUSTER ranks at every size up to hd 128 (G
    8, hd 128, int8 included: ``paged_attention_splitkv_active_clusters``);
    above hd 128 a cluster takes at most WIDE_MAX_CLUSTER ranks
    (``max_cluster``)."""
    ns = int(ns)
    if ns < 1:
        raise ValueError(f"split_clusters: ns must be >= 1, got {ns}")
    K = -(-ns // max_cluster(hd))
    return K, -(-ns // K)


def auto_kv_splits(n_slots: int, KV: int, max_len: int,
                   window: Optional[int] = None) -> int:
    """The engine's kv_splits "auto", from ``attn_sweep.py --only split``
    on the H100 (PERF.md section 6): 1, the single pass, below
    AUTO_SPLIT_ROWS rows of ``max_len`` or above AUTO_SPLIT_HEADS walks
    (``n_slots`` sequences x ``KV`` heads); else AUTO_SPLITS chunks (two
    clusters of 12 ranks a head and the merge pass), which took 0.64-0.98x
    the single pass's time at 32k in every swept shape (B 1-4, KV 8-32, G
    1 and 4, hd 64 and 128, int8 and int4), while at 8k and 16k the best
    single kv_splits took 1.24x and 1.002x the single pass's time at its
    worst shape. Static shapes only: nothing on the device is read. A
    local layer reads min(max_len, ``window``) rows, so under every window
    the repo's configs carry (1024, 4096) it takes the single pass."""
    rows = max_len if window is None else min(max_len, int(window))
    if rows < AUTO_SPLIT_ROWS or n_slots * KV > AUTO_SPLIT_HEADS:
        return 1
    return AUTO_SPLITS


def cluster_chunks(ns: int, K: int) -> list[range]:
    """The chunks each of the K clusters walks, in rank order (the split
    kernel's assignment)."""
    base, extra = divmod(ns, K)
    starts = [k * base + min(k, extra) for k in range(K + 1)]
    return [range(starts[k], starts[k + 1]) for k in range(K)]


def cluster_ranks(extent: int, B: int, KV: int, G: int,
                  unit: int = 1, hd: int = 64) -> tuple[int, int]:
    """(C, rows_per_rank): how the single-pass kernels cut the walk of one
    (sequence, KV head) over the C blocks of a thread-block cluster.
    ``extent`` is the static number of rows (S of the slot cache,
    ``walk_extent`` of the pool: nb * bs, or a window's reach), G the
    query rows a KV head, ``unit`` the rows of one table entry and ``hd``
    the head dim. C is the largest C <= MAX_CLUSTER whose B * KV * C
    blocks fit BLOCKS_PER_SM blocks on each of the CARD_SMS SMs (above hd
    128: the largest C <= WIDE_MAX_CLUSTER whose B * KV clusters the card
    holds at once, ``WIDE_RESIDENT``), so that every cluster is resident
    at once (clusters left for a second wave slow the call;
    ``attn_sweep.py`` measures it), cut so that a rank walks
    MIN_RANK_TILES tiles or more; 1 below 2 * MIN_RANK_TILES tiles. Rank
    c walks rows [c * rows_per_rank, (c + 1) * rows_per_rank): whole tiles
    and whole table entries, the last rank ragged. The lengths never
    enter: choosing C needs no device read."""
    tiles = -(-extent // KERNEL_TILE)
    heads = max(1, B * KV)
    if hd > WIDE_HD:
        fit = max([C for C in range(1, WIDE_MAX_CLUSTER + 1)
                   if WIDE_RESIDENT[C - 1] >= heads], default=1)
    else:
        fit = min(MAX_CLUSTER, BLOCKS_PER_SM[G > 1] * CARD_SMS // heads)
    C = max(1, min(fit, tiles // MIN_RANK_TILES))
    step = max(KERNEL_TILE, unit)             # both powers of two
    rows = -(-(-(-extent // C)) // step) * step
    return -(-extent // rows), rows


def merge_rank_order(acc: torch.Tensor, m: torch.Tensor,
                     l: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """One cluster's merge of its ranks' partials over axis 1, in rank
    order, unnormalised: (sum_c w_c acc_c, M, sum_c w_c l_c) with M =
    max_c m_c and w_c = e^(m_c - M), the sums taken rank after rank."""
    M = m.amax(dim=1)
    num = den = None
    for c in range(m.shape[1]):
        w = torch.exp(m[:, c] - M)
        a, b = acc[:, c] * w[..., None], l[:, c] * w
        num, den = (a, b) if c == 0 else (num + a, den + b)
    return num, M, den


def paged_attention_walk(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths,
                         *, bits: int, kv_splits: int = 1,
                         window: Optional[int] = None,
                         tile: int = KERNEL_TILE, partials: bool = False):
    """The kernels' walk in torch, for the CPU tests. Chunk c of sequence b
    covers table entries [f + c*nbc, min(f + (c+1)*nbc, nb)), cut to rows
    [lo, lengths[b]) with lo = max(0, lengths[b] - window) on a local
    layer (else 0), in tiles of ``tile`` tokens from the chunk's start or
    lo's tile, whichever is later, folded into a running (m, l, acc) with
    the rows below lo masked: the split's chunks for kv_splits > 1 (f = 0),
    the single pass's cluster ranks (``cluster_ranks`` over
    ``walk_extent``; f the entry of lo rounded down to a multiple of
    max(tile, bs)) for kv_splits == 1. With ``partials`` it returns the
    chunks' (acc, m, l); a chunk with no live token keeps m = -1e30, l = 0,
    acc = 0. Otherwise it merges them as the kernels do: the ranks of each
    cluster (the split's ``split_clusters`` / ``cluster_chunks``, the single
    pass's one cluster) in rank order, then the clusters' partials by
    ``merge_splitkv_partials`` (at one cluster that is the normalisation
    alone)."""
    B, KV, G, hd = q.shape
    nb = block_tables.shape[1]
    bs = k_pool.shape[1]
    step = max(tile, bs)
    if kv_splits == 1:
        ns, rows = cluster_ranks(walk_extent(nb, bs, window), B, KV, G, unit=bs,
                                 hd=hd)
        nbc = rows // bs
        groups = [range(ns)]
    else:
        ns, nbc = split_partition(nb, kv_splits)
        groups = cluster_chunks(ns, split_clusters(ns, G, hd, bits)[0])
    dev = q.device
    qf = q.float()
    scale = hd ** -0.5
    acc = torch.zeros((B, ns, KV, G, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, ns, KV, G), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, ns, KV, G), dtype=torch.float32, device=dev)
    for b in range(B):
        n = int(lengths[b])
        lo = max(0, n - int(window)) if window is not None else 0
        f = lo // step * step // bs if kv_splits == 1 else 0
        for c in range(ns):
            e0 = f + c * nbc
            t0 = max(e0 * bs, lo // tile * tile)
            t1 = min(n, min(e0 + nbc, nb) * bs)
            for s0 in range(t0, t1, tile):
                t = torch.arange(s0, min(s0 + tile, t1), device=dev)
                blk, off = block_tables[b, t // bs], t % bs
                kd = dequant_kv_tile(k_pool[blk, off], k_sc[blk, off], bits)
                vd = dequant_kv_tile(v_pool[blk, off], v_sc[blk, off], bits)
                live = t >= lo
                s = torch.where(live, torch.einsum("egh,teh->egt", qf[b], kd) * scale,
                                _NEG)
                m_new = torch.maximum(m[b, c], s.amax(-1))
                p = torch.where(live, torch.exp(s - m_new[..., None]), 0.0)
                corr = torch.exp(m[b, c] - m_new)
                l[b, c] = l[b, c] * corr + p.sum(-1)
                acc[b, c] = acc[b, c] * corr[..., None] + torch.einsum(
                    "egt,teh->egh", p, vd)
                m[b, c] = m_new
    if partials:
        return acc, m, l
    parts = [merge_rank_order(*(x[:, r.start:r.stop] for x in (acc, m, l)))
             for r in groups]
    return merge_splitkv_partials(*(torch.stack(x, dim=1) for x in zip(*parts)))


def check_operands(what: str, tensors, q, k_codes, v_codes,
                   bits: int) -> tuple[int, int, int, int]:
    """The checks every decode-attention kernel shares, on the operands
    ``tensors``: bits, one CUDA device, contiguity, q's type and shape,
    hd and G, and the code dtype. Returns (B, KV, G, hd)."""
    if bits not in POOL_DTYPE:
        raise NotImplementedError(f"{what}: bits={bits} (the kernels take 8 "
                                  "and 4)")
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{what}: every operand must be on the same CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32) or q.ndim != 4:
        raise TypeError(f"{what}: q must be bf16 or f32 (B, KV, G, hd), got "
                        f"{q.dtype} {tuple(q.shape)}")
    B, KV, G, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS or not 1 <= G <= KERNEL_MAX_G:
        raise NotImplementedError(f"{what}: hd={hd}, G={G} (the kernels take "
                                  f"hd in {KERNEL_HEAD_DIMS}, G 1..{KERNEL_MAX_G})")
    if (hd * bits // 8) % 8:
        raise NotImplementedError(f"{what}: hd={hd} at {bits} bits is a "
                                  f"{hd * bits // 8}-byte row, which the kernels' "
                                  "8-byte copies cannot take (int8 takes it)")
    if k_codes.dtype != POOL_DTYPE[bits] or v_codes.dtype != POOL_DTYPE[bits]:
        raise TypeError(f"{what}: a {bits}-bit pool holds {POOL_DTYPE[bits]} "
                        f"codes, got {k_codes.dtype} / {v_codes.dtype}")
    return B, KV, G, hd


def check_codes(what: str, k_codes, k_sc, v_codes, v_sc, want: tuple) -> None:
    """Codes of shape ``want`` (rows, cols, KV, hd * bits / 8) on an 8-byte
    boundary, and f32 scales of shape ``want[:3]``."""
    if tuple(k_codes.shape) != want or tuple(v_codes.shape) != want:
        raise ValueError(f"{what}: pools must be {want}, got "
                         f"{tuple(k_codes.shape)} / {tuple(v_codes.shape)}")
    if k_codes.data_ptr() % 8 or v_codes.data_ptr() % 8:
        raise ValueError(f"{what}: pools must start on an 8-byte boundary "
                         "(the kernels read 8-byte words)")
    for sc in (k_sc, v_sc):
        if sc.dtype != torch.float32 or tuple(sc.shape) != want[:3]:
            raise ValueError(f"{what}: scales must be f32 {want[:3]}, got "
                             f"{sc.dtype} {tuple(sc.shape)}")


def check_wide_rows(what: str, k_codes, v_codes, row_bytes: int) -> None:
    """The kernels copy rows of a multiple of 16 bytes in 16-byte units,
    so such codes must start on a 16-byte boundary."""
    if row_bytes % 16 == 0 and (k_codes.data_ptr() % 16 or v_codes.data_ptr() % 16):
        raise ValueError(f"{what}: codes of {row_bytes}-byte rows must start on a "
                         "16-byte boundary (the kernel copies 16-byte units)")


def _check(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths,
           bits) -> tuple[int, ...]:
    what = "paged_attention kernel"
    B, KV, G, hd = check_operands(
        what, (q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths), q, k_pool,
        v_pool, bits)
    n_blocks, bs = k_pool.shape[:2]
    if bs < 1 or bs & (bs - 1):
        raise NotImplementedError(f"{what}: block size {bs} (the kernels take "
                                  "powers of two)")
    check_codes(what, k_pool, k_sc, v_pool, v_sc, (n_blocks, bs, KV, hd * bits // 8))
    if (block_tables.dtype != torch.int64 or lengths.dtype != torch.int64
            or block_tables.ndim != 2 or block_tables.shape[0] != B
            or block_tables.shape[1] < 1 or tuple(lengths.shape) != (B,)):
        raise ValueError(f"{what}: block tables must be int64 ({B}, nb >= 1) "
                         f"and lengths int64 ({B},), got {block_tables.dtype} "
                         f"{tuple(block_tables.shape)} / {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    return B, KV, G, hd, bs, block_tables.shape[1]


def _window_arg(what: str, window: Optional[int]) -> int:
    """The kernels' window argument: a local layer's window (>= 1), or 0."""
    if window is None:
        return 0
    if int(window) < 1:
        raise ValueError(f"{what}: window must be >= 1 or None, got {window}")
    return int(window)


def _ptrs(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths):
    return (q.data_ptr(), k_pool.data_ptr(), k_sc.data_ptr(), v_pool.data_ptr(),
            v_sc.data_ptr(), block_tables.data_ptr(), lengths.data_ptr())


def paged_attention_cuda(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths,
                         *, bits: int, window: Optional[int] = None) -> torch.Tensor:
    """Launch the single-pass kernel on the current stream (CUDA tensors
    only): one thread-block cluster of C ranks per (b, KV head), C from
    ``cluster_ranks`` over ``walk_extent`` (a local layer's ``window``
    bounds it). Block ids in the tables must lie in [0, n_blocks): the
    kernel reads them unchecked."""
    ops = (q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths)
    B, KV, G, hd, bs, nb = _check(*ops, bits)
    check_wide_rows("paged_attention kernel", k_pool, v_pool, hd * bits // 8)
    win = _window_arg("paged_attention kernel", window)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    C, rows = cluster_ranks(walk_extent(nb, bs, window), B, KV, G, unit=bs, hd=hd)
    lib = build.library("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        *_ptrs(*ops), out.data_ptr(), B, KV, G, hd, bs, nb, bits,
        int(q.dtype == torch.bfloat16), C, rows // bs, win, stream)
    build.check(err, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_attention_active_clusters(B: int, KV: int, G: int, hd: int, bs: int,
                                    nb: int, bits: int, q_dtype: torch.dtype,
                                    window: Optional[int] = None) -> tuple[int, int]:
    """(C, clusters the card holds at once) for the single pass at these
    shapes (``cudaOccupancyMaxActiveClusters``; builds the library)."""
    C, rows = cluster_ranks(walk_extent(nb, bs, window), B, KV, G, unit=bs, hd=hd)
    n = build.library("paged_attention").paged_attention_active_clusters(
        B, KV, G, hd, bs, nb, bits, int(q_dtype == torch.bfloat16), C, rows // bs,
        _window_arg("paged_attention occupancy query", window))
    if n < 0:
        build.check(-n, "paged_attention occupancy query")
    return C, n


def paged_attention_splitkv_cuda(q, k_pool, k_sc, v_pool, v_sc, block_tables,
                                 lengths, *, bits: int, kv_splits: int,
                                 window: Optional[int] = None) -> torch.Tensor:
    """Launch the split on the current stream (CUDA tensors only): the ns
    chunks of ``split_partition``, one cluster rank each, in the K
    clusters of ``split_clusters``. At K == 1 (kv_splits <= the largest
    cluster) one launch merges on chip and writes the output, with no
    scratch; above, the clusters' (acc, m, l) partials are scratch of this
    call and a merge pass follows. On a local layer (``window``) the
    chunks wholly below the window read nothing. Block ids as for
    ``paged_attention_cuda``."""
    ops = (q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths)
    B, KV, G, hd, bs, nb = _check(*ops, bits)
    check_wide_rows("paged_attention_splitkv kernel", k_pool, v_pool, hd * bits // 8)
    win = _window_arg("paged_attention_splitkv kernel", window)
    if int(kv_splits) < 1:
        raise ValueError(f"paged_attention_splitkv kernel: kv_splits must be "
                         f">= 1, got {kv_splits}")
    ns, nbc = split_partition(nb, kv_splits)
    K, C = split_clusters(ns, G, hd, bits)
    dev = q.device
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    scratch = (None, None, None)
    if K > 1:
        acc = torch.empty((B, K, KV, G, hd), dtype=torch.float32, device=dev)
        ml = torch.empty((2, B, K, KV, G), dtype=torch.float32, device=dev)
        scratch = (acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    lib = build.library("paged_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_attention_splitkv_launch(
        *_ptrs(*ops), *scratch, out.data_ptr(), B, KV, G, hd, bs, nb, bits,
        int(q.dtype == torch.bfloat16), ns, nbc, K, C, win, stream)
    build.check(err, "paged_attention_splitkv")
    paged_attention_splitkv_cuda.launches += 1
    return out


paged_attention_splitkv_cuda.launches = 0


def paged_attention_splitkv_active_clusters(B: int, KV: int, G: int, hd: int,
                                            bs: int, nb: int, bits: int,
                                            q_dtype: torch.dtype, kv_splits: int,
                                            window: Optional[int] = None
                                            ) -> tuple[int, int, int]:
    """(K, C, clusters the card holds at once) for the split at these
    shapes: K clusters of C ranks a (sequence, KV head) from
    ``split_clusters``, and ``cudaOccupancyMaxActiveClusters`` of its
    walk (builds the library)."""
    ns, nbc = split_partition(nb, kv_splits)
    K, C = split_clusters(ns, G, hd, bits)
    n = build.library("paged_attention").paged_attention_splitkv_active_clusters(
        B, KV, G, hd, bs, nb, bits, int(q_dtype == torch.bfloat16), ns, nbc, K, C,
        _window_arg("paged_attention_splitkv occupancy query", window))
    if n < 0:
        build.check(-n, "paged_attention_splitkv occupancy query")
    return K, C, n
