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
                         ``KERNEL_TILE`` tokens with a running (m, l, acc),
                         the chunk partition ns = min(kv_splits, nb),
                         nbc = ceil(nb / ns), and a stop at lengths[b]
                         instead of the reference's null-padded tail
  ``*_cuda``             the kernel wrappers; each launches or raises

Callers go through ``kernels/registry.py``. Where lengths[b] is 0 the
oracle averages every row of the table (softmax of all-masked scores);
the kernels and the walk read no row and return 0 there. The engine
never passes a length of 0.

Bound on the H100 and design: see the note at the top of the CUDA source.
"""

from __future__ import annotations

import torch

from . import build
from .ref import dequant_kv_tile, ref_paged_attention, ref_paged_attention_splitkv

_NEG = -1e30
# tokens per tile of the kernels' walk (csrc/paged_attention.cu kTile)
KERNEL_TILE = 128
# what the CUDA source takes (and block sizes that are powers of two)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_MAX_G = 8
POOL_DTYPE = {8: torch.int8, 4: torch.uint8}


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


def paged_attention_walk(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths,
                         *, bits: int, kv_splits: int = 1,
                         tile: int = KERNEL_TILE, partials: bool = False):
    """The kernels' walk in torch, for the CPU tests. Chunk c of sequence b
    covers tokens [c*nbc*bs, min((c+1)*nbc, nb)*bs), cut at lengths[b], in
    tiles of ``tile`` tokens folded into a running (m, l, acc). With
    ``partials`` it returns the split kernel's (acc, m, l); a chunk with no
    live token keeps m = -1e30, l = 0, acc = 0. Otherwise kv_splits == 1
    normalises as the single-pass kernel does (acc / max(l, 1e-30)) and
    kv_splits > 1 merges."""
    B, KV, G, hd = q.shape
    nb = block_tables.shape[1]
    bs = k_pool.shape[1]
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
    if kv_splits == 1:
        return acc[:, 0] / torch.clamp(l[:, 0], min=1e-30)[..., None]
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
    only): one block per (b, KV head). Block ids in the tables must lie in
    [0, n_blocks): the kernel reads them unchecked."""
    ops = (q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths)
    B, KV, G, hd, bs, nb = _check(*ops, bits)
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    lib = build.library("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        *_ptrs(*ops), out.data_ptr(), B, KV, G, hd, bs, nb, bits,
        int(q.dtype == torch.bfloat16), stream)
    build.check(err, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


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
