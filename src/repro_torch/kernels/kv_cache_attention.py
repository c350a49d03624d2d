"""Decode attention over a dense packed KV cache: the CUDA kernel
(``csrc/kv_cache_attention.cu``), its wrapper, and the plain PyTorch
version.

Replaces ``src/repro/kernels/kv_cache_attention.py``:
``kv_cache_attention_pallas``. One query row per sequence and KV head
group: q (B, KV, G, hd) bf16/f32 against a slot-per-sequence cache of int8
codes (B, S, KV, hd) or 4-bit codes (B, S, KV, hd/2) u8 (low nibble
first) with (B, S, KV) f32 scales, and lengths (B,); out (B, KV, G, hd)
f32, rows >= lengths[b] masked. The fixed-batch serve loop's decode step
calls it in every layer with lengths pos + 1, and on a local layer, whose
cache is a ring of W = min(max_len, window) rows, with min(pos + 1, W): the
ring's live rows, so the kernel needs no window.

Two formulations live here:
  ``kv_cache_attention_walk``  the plain version (``_plain`` is the same
                               function, under the registry's name): the
                               kernel's walk replayed in torch, operation
                               for operation, so that on the card the two
                               give the same bits. The rows are cut into
                               the C ranks of ``cluster_ranks`` (the
                               kernel's thread-block cluster), batched as
                               one axis; each rank walks rows t <
                               min(lengths[b], S) of its chunk in tiles of
                               ``KERNEL_TILE``, at the head dim the kernel
                               compiles (``kernel_head_dim``: hd 120 as 128,
                               q and the codes zero in the 8 pad dims): the
                               scores of a row summed
                               word by word and the words met in a
                               butterfly; an online softmax whose sums run
                               lane by lane; the PV sums in ``R``
                               interleaved token groups. The ranks' sums
                               then merge in rank order. Each product and
                               sum rounds on its own, as the kernel's
                               ``__fmul_rn`` / ``__fadd_rn`` do. At C = 1
                               the merge is exact (weight 1) and the walk is
                               one block's over the whole cache. The CPU
                               tests hold it against the reference's oracle
                               (``ref_kv_cache_attention``) and Pallas
                               kernel
  ``kv_cache_attention_cuda``  the kernel wrapper; it launches or raises

Why the plain version replays the kernel: in the fixed-batch loop every
call of the kernel agreed with the oracle within 3.2e-7 of max|out|, yet
codeqwen1.5-7b's first decode step logits moved by 0.04 of max|logit|
against the oracle's (``chip_smoke.py`` phase 11 on an NVIDIA H100 80GB
HBM3 at 700 W: a last-ulp change rounds a bf16 attention output the other
way, and 32 layers of a quantized random model amplify it). Tied to the
kernel's order the comparison reads 0; a change to the kernel's walk, its
rank split or its merge must change this replay with it.

Callers go through ``kernels/registry.py``. Where lengths[b] is 0 the
oracle averages every row (softmax of all-masked scores); the kernel and
the walk read no row and return 0 there. The serve loop never passes 0.

Bound on the H100 and design: see the notes at the top of the CUDA source
and of ``csrc/attn_common.cuh``.
"""

from __future__ import annotations

import math

import torch

from . import build
from .paged_attention import (KERNEL_TILE, check_codes, check_operands, check_wide_rows,
                              cluster_ranks, kernel_head_dim)
from .ref import WARP, _unpack4, butterfly_sum

KERNEL_THREADS = 256        # threads per block (csrc/attn_common.cuh kThreads)
_NEG = -1e30


def _codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., hd * bits / 8) codes -> (..., hd) f32 code values."""
    if bits == 4:
        return _unpack4(packed).to(torch.float32) - 8.0
    return packed.to(torch.float32)


def kv_cache_attention_walk(q, k_packed, k_sc, v_packed, v_sc, lengths, *,
                            bits: int, partials: bool = False):
    """The kernel's walk (``attend_rows_cluster`` in csrc/attn_common.cuh)
    in torch. Rank c of ``cluster_ranks(S, B, KV, G)`` walks rows [c * rows,
    (c + 1) * rows) cut at min(lengths[b], S); the ranks are one batch
    axis. Tiles past a rank's live rows are walked too; with every row
    masked they leave (m, l, acc) bit for bit as they were (corr = exp(0)
    = 1, products 0), so one loop serves every rank of every sequence.
    With ``partials`` it returns the ranks' (sums (B, C, KV, G, hd), m, l
    (B, C, KV, G)) before the merge; a rank with no live row keeps m =
    -1e30, l = 0 and sums 0."""
    B, KV, G, hd_real = q.shape
    S = k_packed.shape[1]
    dev = q.device
    f32 = torch.float32
    hd = kernel_head_dim(hd_real)             # the head dim the kernel compiles
    cpw = 64 // bits                          # codes per 8-byte word
    wpr = hd // cpw                           # words (lane parts) per row
    R = KERNEL_THREADS // hd                  # token groups of the PV step
    T = KERNEL_TILE
    C, rows = cluster_ranks(S, B, KV, G, hd=hd_real)
    scale = float(torch.tensor(1.0 / math.sqrt(hd_real), dtype=f32))   # the kernel's f32
    pad = C * rows - S
    n = torch.clamp(lengths, 0, S)
    n_c = torch.clamp(n[:, None] - rows * torch.arange(C, device=dev), 0, rows)  # (B, C)
    kc = _codes(k_packed, bits)                                  # (B, S, KV, hd_real)
    vc = _codes(v_packed, bits)
    if hd != hd_real:                         # the pad dims: zero codes, zero q
        kc, vc = (torch.nn.functional.pad(x, (0, hd - hd_real)) for x in (kc, vc))
        q = torch.nn.functional.pad(q, (0, hd - hd_real))
    ksc, vsc = k_sc.to(f32), v_sc.to(f32)
    if pad:
        kc, vc = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in (kc, vc))
        ksc, vsc = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (ksc, vsc))
    kc, vc = (x.reshape(B, C, rows, KV, hd) for x in (kc, vc))
    ksc, vsc = (x.reshape(B, C, rows, KV) for x in (ksc, vsc))
    qw = q.to(f32).reshape(B, 1, KV, G, wpr, cpw)
    m = torch.full((B, C, KV, G), _NEG, dtype=f32, device=dev)
    l = torch.zeros((B, C, KV, G), dtype=f32, device=dev)
    acc = torch.zeros((B, C, KV, G, R, hd), dtype=f32, device=dev)
    for s0 in range(0, rows, T):
        live = (s0 + torch.arange(T, device=dev)) < n_c[..., None]   # (B, C, T)
        live = live[:, :, None, None]
        kt = kc[:, :, s0:s0 + T].permute(0, 1, 3, 2, 4).reshape(B, C, KV, 1, T, wpr, cpw)
        # scores: word by word, then the butterfly over the row's words
        dot = torch.zeros((B, C, KV, G, T, wpr), dtype=f32, device=dev)
        for j in range(cpw):
            dot = dot + qw[..., None, :, j] * kt[..., j]
        sc = butterfly_sum(dot) * ksc[:, :, s0:s0 + T].transpose(2, 3)[:, :, :, None] * scale
        sc = torch.where(live, sc, _NEG)                         # (B, C, KV, G, T)
        # online softmax: lane L sums p[L], p[L + 32], ...; the lanes meet
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.where(live, torch.exp(sc - m_new[..., None]), 0.0)
        lanes = torch.zeros((B, C, KV, G, WARP), dtype=f32, device=dev)
        for i in range(0, T, WARP):
            lanes = lanes + p[..., i:i + WARP]
        corr = torch.exp(m - m_new)
        l = l * corr + butterfly_sum(lanes)
        m = m_new
        # PV: group r sums tokens r, r + R, ... of the tile for every dim
        vv = (vc[:, :, s0:s0 + T].permute(0, 1, 3, 2, 4)
              * vsc[:, :, s0:s0 + T].transpose(2, 3)[..., None])  # (B, C, KV, T, hd)
        tacc = torch.zeros_like(acc)
        for i in range(0, T, R):
            tacc = tacc + p[..., i:i + R, None] * vv[:, :, :, None, i:i + R]
        acc = acc * corr[..., None, None] + tacc
    sums = torch.zeros((B, C, KV, G, hd), dtype=f32, device=dev)
    for r in range(R):
        sums = sums + acc[..., r, :]
    sums = sums[..., :hd_real]
    if partials:
        return sums, m, l
    # the merge, in rank order: M = max m_c, w_c = exp(m_c - M)
    w = torch.exp(m - m.amax(1, keepdim=True))
    num, den = w[:, 0, ..., None] * sums[:, 0], w[:, 0] * l[:, 0]
    for c in range(1, C):
        num = num + w[:, c, ..., None] * sums[:, c]
        den = den + w[:, c] * l[:, c]
    return num / torch.clamp(den, min=1e-30)[..., None]


# the plain version the registry runs: the replay above, tied to the kernel
kv_cache_attention_plain = kv_cache_attention_walk


def kv_cache_attention_cuda(q, k_packed, k_sc, v_packed, v_sc, lengths, *,
                            bits: int) -> torch.Tensor:
    """Launch the kernel on the current stream (CUDA tensors only): one
    thread-block cluster of C ranks per (b, KV head), C from
    ``cluster_ranks``. Lengths above S read S rows."""
    what = "kv_cache_attention kernel"
    ops = (q, k_packed, k_sc, v_packed, v_sc, lengths)
    B, KV, G, hd = check_operands(what, ops, q, k_packed, v_packed, bits)
    S = k_packed.shape[1] if k_packed.ndim == 4 else 0
    check_codes(what, k_packed, k_sc, v_packed, v_sc, (B, S, KV, hd * bits // 8))
    check_wide_rows(what, k_packed, v_packed, hd * bits // 8)
    if S < 1:
        raise ValueError(f"{what}: the cache must hold at least one row")
    if lengths.dtype != torch.int64 or tuple(lengths.shape) != (B,):
        raise ValueError(f"{what}: lengths must be int64 ({B},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    C, rows = cluster_ranks(S, B, KV, G, hd=hd)
    lib = build.library("kv_cache_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.kv_cache_attention_launch(
        *(t.data_ptr() for t in ops), out.data_ptr(), B, S, KV, G, hd, bits,
        int(q.dtype == torch.bfloat16), C, rows, stream)
    build.check(err, "kv_cache_attention")
    kv_cache_attention_cuda.launches += 1
    return out


kv_cache_attention_cuda.launches = 0


def kv_cache_attention_active_clusters(B: int, S: int, KV: int, G: int, hd: int,
                                       bits: int,
                                       q_dtype: torch.dtype) -> tuple[int, int]:
    """(C, clusters the card holds at once) for the kernel at these shapes
    (``cudaOccupancyMaxActiveClusters``; builds the library)."""
    C, rows = cluster_ranks(S, B, KV, G, hd=hd)
    n = build.library("kv_cache_attention").kv_cache_attention_active_clusters(
        B, S, KV, G, hd, bits, int(q_dtype == torch.bfloat16), C, rows)
    if n < 0:
        build.check(-n, "kv_cache_attention occupancy query")
    return C, n
