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
out (B, KV, G, hd) f32, rows >= lengths[b] masked.

Three formulations live here:
  ``*_plain``            the oracles of ``kernels/ref.py``: gather a dense
                         view and take a masked softmax (the CPU path, and
                         what the card's kernels are held against)
  ``paged_attention_walk`` the kernels' own walk in torch: tiles of
                         ``KERNEL_TILE`` tokens with a running (m, l, acc)
                         over chunks of the table, then the exact merge.
                         The split's chunks are ns = min(kv_splits, nb) of
                         nbc = ceil(nb / ns) entries; the single pass's are
                         the C ranks of its thread-block cluster, from
                         ``cluster_ranks``. Each stops at lengths[b] instead
                         of the reference's null-padded tail
  ``*_cuda``             the kernel wrappers; each launches or raises

``cluster_ranks`` is the one place that chooses how many ranks C the
single-pass kernels (this one and ``kv_cache_attention``) split a walk
into; it reads static shapes only, so no decode step waits on the device
to choose it.

Callers go through ``kernels/registry.py``. Where lengths[b] is 0 the
oracle averages every row of the table (softmax of all-masked scores);
the kernels and the walk read no row and return 0 there. The engine
never passes a length of 0.

Bound on the H100 and design: see the notes at the top of the CUDA source
and of ``csrc/attn_common.cuh``.
"""

from __future__ import annotations

import torch

from repro_torch.device import CARD_SMS
from . import build
from .ref import dequant_kv_tile, ref_paged_attention, ref_paged_attention_splitkv

_NEG = -1e30
# tokens per tile of the kernels' walk (csrc/paged_attention.cu kTile)
KERNEL_TILE = 128
# what the CUDA source takes (and block sizes that are powers of two)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_MAX_G = 8
POOL_DTYPE = {8: torch.int8, 4: torch.uint8}
# the single-pass kernels' cluster split (over device.CARD_SMS SMs): the
# largest cluster (csrc/attn_common.cuh kMaxCluster; above 8 a non-portable
# size), the blocks an SM should hold at once (G == 1 / G > 1), and the
# fewest tiles a rank should walk
MAX_CLUSTER = 16
BLOCKS_PER_SM = (3, 2)
MIN_RANK_TILES = 2


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
                          *, bits: int) -> torch.Tensor:
    """The plain PyTorch version (any device): the reference's oracle."""
    return ref_paged_attention(q, k_pool, k_sc, v_pool, v_sc, block_tables,
                               lengths, bits)


def paged_attention_splitkv_plain(q, k_pool, k_sc, v_pool, v_sc, block_tables,
                                  lengths, *, bits: int,
                                  kv_splits: int) -> torch.Tensor:
    """The plain PyTorch version (any device): the reference's oracle."""
    return ref_paged_attention_splitkv(q, k_pool, k_sc, v_pool, v_sc,
                                       block_tables, lengths, bits,
                                       kv_splits=kv_splits)


def split_partition(nb: int, kv_splits: int) -> tuple[int, int]:
    """(ns, nbc): the number of chunks and the table entries per chunk."""
    ns = max(1, min(int(kv_splits), nb))
    return ns, -(-nb // ns)


def cluster_ranks(extent: int, B: int, KV: int, G: int,
                  unit: int = 1) -> tuple[int, int]:
    """(C, rows_per_rank): how the single-pass kernels cut the walk of one
    (sequence, KV head) over the C blocks of a thread-block cluster.
    ``extent`` is the static number of rows (S of the slot cache, nb * bs
    of the pool), G the query rows a KV head and ``unit`` the rows of one
    table entry. C is the largest C <= MAX_CLUSTER whose B * KV * C blocks
    fit BLOCKS_PER_SM blocks on each of the CARD_SMS SMs, so that every
    cluster is resident at once (clusters left for a second wave slow the
    call; ``attn_sweep.py`` measures it), cut so that a rank walks
    MIN_RANK_TILES tiles or more; 1 below 2 * MIN_RANK_TILES tiles. Rank c walks rows [c * rows_per_rank, (c + 1) *
    rows_per_rank): whole tiles and whole table entries, the last rank
    ragged. The lengths never enter: choosing C needs no device read."""
    tiles = -(-extent // KERNEL_TILE)
    per_sm = BLOCKS_PER_SM[G > 1]
    C = max(1, min(MAX_CLUSTER, per_sm * CARD_SMS // max(1, B * KV),
                   tiles // MIN_RANK_TILES))
    step = max(KERNEL_TILE, unit)             # both powers of two
    rows = -(-(-(-extent // C)) // step) * step
    return -(-extent // rows), rows


def paged_attention_walk(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths,
                         *, bits: int, kv_splits: int = 1,
                         tile: int = KERNEL_TILE, partials: bool = False):
    """The kernels' walk in torch, for the CPU tests. Chunk c of sequence b
    covers tokens [c*nbc*bs, min((c+1)*nbc, nb)*bs), cut at lengths[b], in
    tiles of ``tile`` tokens folded into a running (m, l, acc): the
    split's chunks for kv_splits > 1, the single pass's cluster ranks
    (``cluster_ranks``) for kv_splits == 1. With ``partials`` it returns
    the chunks' (acc, m, l); a chunk with no live token keeps m = -1e30,
    l = 0, acc = 0. Otherwise it merges them, as both kernels do."""
    B, KV, G, hd = q.shape
    nb = block_tables.shape[1]
    bs = k_pool.shape[1]
    if kv_splits == 1:
        ns, rows = cluster_ranks(nb * bs, B, KV, G, unit=bs)
        nbc = rows // bs
    else:
        ns, nbc = split_partition(nb, kv_splits)
    dev = q.device
    qf = q.float()
    scale = hd ** -0.5
    acc = torch.zeros((B, ns, KV, G, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, ns, KV, G), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, ns, KV, G), dtype=torch.float32, device=dev)
    for b in range(B):
        n = int(lengths[b])
        for c in range(ns):
            t0, t1 = c * nbc * bs, min(n, min((c + 1) * nbc, nb) * bs)
            for s0 in range(t0, t1, tile):
                t = torch.arange(s0, min(s0 + tile, t1), device=dev)
                blk, off = block_tables[b, t // bs], t % bs
                kd = dequant_kv_tile(k_pool[blk, off], k_sc[blk, off], bits)
                vd = dequant_kv_tile(v_pool[blk, off], v_sc[blk, off], bits)
                s = torch.einsum("egh,teh->egt", qf[b], kd) * scale
                m_new = torch.maximum(m[b, c], s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m[b, c] - m_new)
                l[b, c] = l[b, c] * corr + p.sum(-1)
                acc[b, c] = acc[b, c] * corr[..., None] + torch.einsum(
                    "egt,teh->egh", p, vd)
                m[b, c] = m_new
    if partials:
        return acc, m, l
    return merge_splitkv_partials(acc, m, l)


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
    """The single-pass kernels copy rows of 16 bytes or more in 16-byte
    units, so such codes must start on a 16-byte boundary."""
    if row_bytes >= 16 and (k_codes.data_ptr() % 16 or v_codes.data_ptr() % 16):
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


def _ptrs(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths):
    return (q.data_ptr(), k_pool.data_ptr(), k_sc.data_ptr(), v_pool.data_ptr(),
            v_sc.data_ptr(), block_tables.data_ptr(), lengths.data_ptr())


def paged_attention_cuda(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths,
                         *, bits: int) -> torch.Tensor:
    """Launch the single-pass kernel on the current stream (CUDA tensors
    only): one thread-block cluster of C ranks per (b, KV head), C from
    ``cluster_ranks``. Block ids in the tables must lie in [0, n_blocks):
    the kernel reads them unchecked."""
    ops = (q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths)
    B, KV, G, hd, bs, nb = _check(*ops, bits)
    check_wide_rows("paged_attention kernel", k_pool, v_pool, hd * bits // 8)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    C, rows = cluster_ranks(nb * bs, B, KV, G, unit=bs)
    lib = build.library("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        *_ptrs(*ops), out.data_ptr(), B, KV, G, hd, bs, nb, bits,
        int(q.dtype == torch.bfloat16), C, rows // bs, stream)
    build.check(err, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_attention_active_clusters(B: int, KV: int, G: int, hd: int, bs: int,
                                    nb: int, bits: int,
                                    q_dtype: torch.dtype) -> tuple[int, int]:
    """(C, clusters the card holds at once) for the single pass at these
    shapes (``cudaOccupancyMaxActiveClusters``; builds the library)."""
    C, rows = cluster_ranks(nb * bs, B, KV, G, unit=bs)
    n = build.library("paged_attention").paged_attention_active_clusters(
        B, KV, G, hd, bs, nb, bits, int(q_dtype == torch.bfloat16), C, rows // bs)
    if n < 0:
        build.check(-n, "paged_attention occupancy query")
    return C, n


def paged_attention_splitkv_cuda(q, k_pool, k_sc, v_pool, v_sc, block_tables,
                                 lengths, *, bits: int,
                                 kv_splits: int) -> torch.Tensor:
    """Launch the split kernel, one block per (b, chunk, KV head), and its
    merge pass on the current stream (CUDA tensors only). The (acc, m, l)
    partials are scratch of this call. Block ids as for
    ``paged_attention_cuda``."""
    ops = (q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths)
    B, KV, G, hd, bs, nb = _check(*ops, bits)
    if int(kv_splits) < 1:
        raise ValueError(f"paged_attention_splitkv kernel: kv_splits must be "
                         f">= 1, got {kv_splits}")
    ns, nbc = split_partition(nb, kv_splits)
    dev = q.device
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    acc = torch.empty((B, ns, KV, G, hd), dtype=torch.float32, device=dev)
    ml = torch.empty((2, B, ns, KV, G), dtype=torch.float32, device=dev)
    lib = build.library("paged_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_attention_splitkv_launch(
        *_ptrs(*ops), acc.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr(),
        out.data_ptr(), B, KV, G, hd, bs, nb, bits, int(q.dtype == torch.bfloat16),
        ns, nbc, stream)
    build.check(err, "paged_attention_splitkv")
    paged_attention_splitkv_cuda.launches += 1
    return out


paged_attention_splitkv_cuda.launches = 0
