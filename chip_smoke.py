#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one card.

  python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases, each printing its lines:
  1 device    the card's name and count, nvidia-smi's name and power limit
  2 settings  TF32 off for f32 matmuls and convolutions
  3 build     nvcc builds every kernel source for sm_90a (-Xptxas -v),
              or loads the library already built from the same sources
  4 kernels   each kernel against its plain PyTorch version at the serving
              shapes of qwen1.5-0.5b (K x N = 1024x1024, 1024x2816,
              2816x1024; M = 1, 4, 32) and, for lut_gemm_bs_fused, of
              codeqwen1.5-7b (4096x4096, 4096x13440, 13440x4096; M = 1, 4),
              with kernel, plain, library (torch.matmul of bf16 activations
              against the pre-dequantized bf16 weight) and bound times; the
              two-step lut_gemm_bitsliced (the row-parallel route of phase
              13) at qwen's shapes and at the K slices tp=2 gives it (512 x
              1024, 1408 x 1024), M 1, 4, 32, w2 and w4, per channel and g64,
              and at codeqwen's shapes (M 4, w2, per channel and g64); both
              bit-sliced kernels at the edges (M 1 and M 33, one group per
              row, N off the column tile, K off the 16-group segment, groups
              of one pattern byte, a group spanning segments, a ragged last
              rank, every code -128 against every pattern 0xF at w2 and w4,
              codeqwen's w_down, K 13440, in groups of 4, which takes
              several rounds). Each bit-sliced line prints its tiling
              (kernels/lut_gemm_bitsliced.py::bs_partition: MT rows, NT
              columns, C cluster ranks, the rounds), its blocks and
              cudaOccupancyMaxActiveClusters; the
              paged-attention pair at the qwen and codeqwen serve shapes,
              at 8k and 32k context (block 512), with G = 8 and at the edges
              (length 1, lengths off the block size, null-padded tables,
              kv_splits above the table width, chunks past every length,
              and a ragged 5008-row table whose single pass runs on 10
              cluster ranks, 8 of them past one sequence's length),
              the library time being scaled_dot_product_attention over the
              pre-dequantized bf16 view; and the two expert GEMMs at
              moonshot-v1-16b-a3b's decode shapes (E 64, M 4, K x N =
              2048x1408 and 1408x2048; w2 per channel and g64, w4 for the
              dequant kernel), at M 16, and at the edges (E 1, N off the
              warp tile, K off the word step, groups smaller than a lane
              step and one group per row, zero rows of unfilled capacity
              slots), the library time being torch.bmm of the bf16
              activations against the pre-dequantized bf16 weights; and
              kv_cache_attention over a dense slot cache at the fixed
              loop's serve shapes (qwen int8 and codeqwen int4, S 48), a
              GQA shape with S 1000, 8k / 32k context and a ragged S 5000
              (lengths 4999 and 700), the library time being
              scaled_dot_product_attention over the pre-dequantized bf16
              view. Each single-pass attention line prints its cluster
              size C (kernels/paged_attention.py::cluster_ranks), its
              blocks and cudaOccupancyMaxActiveClusters
  5 engine    qwen1.5-0.5b at full width with seeded random weights, packed
              under w2a2, w2a16 and w2a8_bs in turn, serving 12 requests
              through the paged engine via repro_torch.launch.serve; launch
              counts set to 0 just before each run and read just after: the
              plan's kernel launches 7 x 24 times per forward, the others 0;
              paged_attention 24 times per decode step, the split kernel 0
  6 plain     the same runs with the registry's GEMMs forced onto the plain
              versions on the card (attention stays on its kernel): under
              w2a2 and w2a8_bs, whose kernels are bit-identical to their
              plain versions, greedy tokens and first-decode-step logits
              must be identical; w2a16 first-decode-step logits within the
              stated tolerance. Then the same runs with the GEMM kernels on
              and attention on its plain version (attn_backend "ref"):
              first-decode-step logits within the stated tolerance
  7 profile   torch.profiler over a few engine steps of each plan: wall
              and device-busy time per step (the device's idle share),
              kernels per step, and the top host and device ops; the
              port's standing source of the idle share until it has a
              benchmark of its own
  8 long      qwen1.5-0.5b under w2a8_bs, 2 slots planted decode-ready at
              8192 and 32768 tokens of context in a pool of 512-row blocks
              filled from a seeded generator; 3 warm-up and 12 timed decode
              steps with kv_splits 1 (paged_attention) and 8
              (paged_attention_splitkv) on byte-identical state, and a
              first step with attention on its plain version; every
              attention call of the first step checked against its plain
              version on the same inputs; launch counts, logits, tokens,
              step times and a profile of each; and, not as a gate, how far
              the plain single pass and the plain split move the logits
  9 codeqwen  codeqwen1.5-7b at full width (32 layers, untied head, int4
              pool) under w2a8_bs serving the 12 requests, with the
              attention-plain comparison and a profile, after the qwen
              engines are freed
  10 moe      moonshot-v1-16b-a3b at full width (48 layers, 64 experts,
              top-6, two shared experts, untied head, int8 pool), drawn and
              packed layer by layer, serving the 12 requests under w2a2
              (expert_lut_gemm + lut_gemm) and w2a16 (expert_dequant_matmul +
              dequant_matmul), after the codeqwen engine is freed: launch
              counts exact (the expert op 3 x 48 per forward, the dense op
              7 x 48, paged_attention 48 per decode step, the others 0); a
              re-run with the expert and dense GEMMs on their plain versions
              (w2a2: tokens and first-step logits identical; w2a16: logits
              within the stated tolerance); a profile; peak device memory
  11 fixed    the fixed-batch loop (serve.py without --paged: 4 prompts of
              32 tokens, 16 generated) at full width and depth:
              qwen1.5-0.5b (int8 slot cache) under w2a2, w2a16 and w2a8_bs,
              and codeqwen1.5-7b (int4 cache, hd 128) under w2a8_bs.
              Launch counts exact (kv_cache_attention layers x 15, the
              plan's GEMM 7 x layers x 16, the paged pair 0); every
              kv_cache_attention call of the first decode step
              bit-identical to its plain version; a plain-GEMM re-run
              (w2a2 and w2a8_bs: tokens and first-step logits identical;
              w2a16: logits within the stated tolerance), an
              attention-plain re-run (logits within the stated tolerance)
              and a profile of 4 decode steps
  12 moe g64  moonshot-v1-16b-a3b at full width and depth under the grouped
              w2a2g64 plan through the fixed-batch loop: expert_lut_gemm
              launches exactly 3 x 48 x 16 times; a plain-GEMM re-run gives
              identical greedy tokens and first-step logits within the
              stated tolerance
  13 tp       tensor-parallel serving (serve.py --tp 2 --paged): 2 ranks
              spawned on this card through the port's launcher (gloo: NCCL
              refuses two ranks on one card), qwen1.5-0.5b at full width
              and depth serving phase 5's 12 requests under w2a8_bs. Launch
              counts exact on each rank (lut_gemm_bitsliced 2 x 24 and
              lut_gemm_bs_fused 5 x 24 per forward, paged_attention 24 per
              decode step, the others 0); both ranks' greedy tokens and
              first-decode-step logits identical to each other and to phase
              5's w2a8_bs run, bit for bit; every lut_gemm_bitsliced call of
              the first decode step identical to its plain version on the
              same local inputs; each rank's packed planes exactly half of
              the single-rank tree's. Then w2a8_bs_g64 the same way against a
              single-rank g64 run: first-step calls within the grouped
              tolerance, first-step logits within the stated tolerance.
              Prints the backend, the decode-only step, tok/s and the bytes
              per rank: two ranks sharing one card through gloo measure
              correctness, not tensor-parallel speed

Any failure exits nonzero. The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}. Without a CUDA
card, or without the repository's src/repro_torch beside this file, it
exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W). The bound of
# each kernel takes the fastest units that compute the same function on its
# inputs: the codebook levels are small integers, so lut_gemm's integer LUT
# sums are an int8 product with int32 sums, and dequant_matmul is a bf16
# product of the activations with the exact bf16 levels, f32 sums, with the
# scales (per channel or per group) applied to the sums as an epilogue.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS = 1979e12       # int8 tensor cores
BF16_TC_FLOPS = 989e12      # bf16 tensor cores

# tolerances (stated): lut_gemm with an integer LUT sums exact integers in
# f32, so it must be bit-identical; with group scales the summation order
# differs from the plain version's. dequant_matmul and expert_dequant_matmul
# round each product and each sum on their own in the order their plain
# versions repeat, so they must be bit-identical. lut_gemm_bs_fused quantizes
# the rows with the plain version's arithmetic and sums exact integers, so per
# channel it must be bit-identical; its group-scale sum runs in another order.
TOL_LUT_GROUPED = 1e-5      # relative to max|plain|
TOL_BS_GROUPED = 1e-5       # relative to max|plain|
TOL_LOGITS = 2e-2           # w2a16 first decode step, relative to max|logit|
# paged attention: f32 sums and exponentials in another order than the plain
# version's dense masked softmax, the K scale factored out of the dot product.
# kv_cache_attention's plain version replays its kernel's walk operation for
# operation (kernels/kv_cache_attention.py), so the two must be bit-identical
TOL_ATTN = 1e-5             # relative to max|plain|
# expert_lut_gemm sums exact integers per channel (bit-identical) and scales
# each packed byte's partial sum where the plain version scales each group's
TOL_EXPERT_GROUPED = 1e-5   # relative to max|plain|

SHAPES = ((1024, 1024), (1024, 2816), (2816, 1024))   # (K, N) per projection
ROWS = (1, 4, 32)                                      # decode / prefill chunk
REPRESENTATIVE = (4, 1024, 2816)                       # (M, K, N) in the JSON
CODEQWEN_SHAPES = ((4096, 4096), (4096, 13440), (13440, 4096))
CODEQWEN_ROWS = (1, 4)
# long-context decode (the port's counterpart of benchmarks/serving.py's
# planted long-context workload): qwen1.5-0.5b, 2 slots, 512-row blocks
LC_CONTEXTS = (8192, 32768)
LC_BLOCK = 512
LC_SLOTS = 2
LC_WARM, LC_GEN = 3, 12
LC_SPLITS = 8
# moonshot-v1-16b-a3b's expert GEMMs (E, M, K, N): gate/up and down at decode
# (capacity 4), gate/up at a prefill-like M
EXPERT_SHAPES = ((64, 4, 2048, 1408), (64, 4, 1408, 2048), (64, 16, 2048, 1408))
EXPERT_REPRESENTATIVE = (64, 4, 2048, 1408)
# kv_cache_attention: (label, B, KV, G, hd, bits, S, lengths, q dtype); the
# serve shapes are the fixed loop's (P 32 + gen 16 rows, lengths 33-47)
KV_CACHE_ROWS = (
    ("qwen serve", 4, 16, 1, 64, 8, 48, (33, 38, 42, 47), "bf16"),
    ("codeqwen serve", 4, 32, 1, 128, 4, 48, (33, 38, 42, 47), "bf16"),
    ("GQA G 4, S 1000", 2, 4, 4, 64, 8, 1000, (999, 517), "f32"),
    ("long 8k", 2, 16, 1, 64, 8, 8192, (8192, 8192), "bf16"),
    ("long 32k", 2, 16, 1, 64, 8, 32768, (32768, 32768), "bf16"),
    ("ragged, ranks past a length", 2, 16, 1, 64, 8, 5000, (4999, 700), "bf16"),
)
# the fixed-batch loop's runs: (arch, plan, the plan's dense GEMM op)
FIXED_RUNS = (("qwen1.5-0.5b", "w2a2", "lut_gemm"),
              ("qwen1.5-0.5b", "w2a16", "dequant_matmul"),
              ("qwen1.5-0.5b", "w2a8_bs", "lut_gemm_bs_fused"),
              ("codeqwen1.5-7b", "w2a8_bs", "lut_gemm_bs_fused"))


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def graph_ms(torch, fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events, so host launch
    overhead is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(n_bytes: int, n_ops: int, peak: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def phase_kernels(torch, dev):
    from repro_torch.core import packing, quant
    from repro_torch.core.lut import product_lut
    from repro_torch.kernels.lut_dequant_matmul import (dequant_matmul_cuda,
                                                        dequant_matmul_plain)
    from repro_torch.kernels.lut_gemm import lut_gemm_cuda, lut_gemm_plain
    from repro_torch.kernels.lut_gemm_bitsliced import (lut_gemm_bs_fused_cuda,
                                                        lut_gemm_bs_fused_plain)

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {"lut_gemm": [], "dequant_matmul": [], "lut_gemm_bs_fused": []}

    def codes(shape, bits):
        return torch.randint(0, 2 ** bits, shape, generator=gen, device=dev,
                             dtype=torch.uint8)

    def record(name, cfg, M, K, N, err, tol_ok, k_ms, p_ms, l_ms, b, by, tiling=None):
        row = {"kernel": name, "cfg": cfg, "M": M, "K": K, "N": N,
               "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": b, "bound_by": by}
        if tiling:
            row.update(tiling)
        rows[name].append(row)
        print(f"  {name:17s} {cfg:14s} M={M:<3d} K={K:<5d} N={N:<5d} "
              f"err={err:.3g} kernel={k_ms:.5f}ms plain={p_ms:.5f}ms "
              f"library={l_ms:.5f}ms bound={b:.5f}ms ({by})"
              + (f"; {bs_tiling_text(tiling)}" if tiling else ""), flush=True)
        if not tol_ok:
            fail(f"{name} {cfg} M={M} K={K} N={N} disagrees with its plain "
                 f"version: max_abs_err={err}")

    for K, N in SHAPES:
        for M in ROWS:
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            # lut_gemm: w2a2, w2a2g64, w4a8
            for wb, ab, G in ((2, 2, None), (2, 2, 64), (4, 8, None)):
                a_idx, w_idx = codes((M, K), ab), codes((N, K), wb)
                ap, wp = packing.pack(a_idx, ab), packing.pack(w_idx, wb)
                lut = product_lut(quant.uniform_codebook(wb, device=dev),
                                  quant.uniform_codebook(ab, device=dev)).table
                sc = None if G is None else (
                    torch.rand((N, K // G), generator=gen, device=dev) * 0.1 + 0.01)
                got = lut_gemm_cuda(ap, wp, lut, sc, w_bits=wb, a_bits=ab,
                                    group_size=G)
                torch.cuda.synchronize()
                want = lut_gemm_plain(ap, wp, lut, sc, w_bits=wb, a_bits=ab,
                                      group_size=G)
                err = (got - want).abs().max().item()
                ok = err == 0.0 if G is None else \
                    err <= TOL_LUT_GROUPED * max(1.0, want.abs().max().item())
                w_deq = (quant.uniform_codebook(wb, device=dev).levels[w_idx.long()]
                         ).to(torch.bfloat16)
                k_ms = graph_ms(torch, lambda: lut_gemm_cuda(
                    ap, wp, lut, sc, w_bits=wb, a_bits=ab, group_size=G))
                p_ms = graph_ms(torch, lambda: lut_gemm_plain(
                    ap, wp, lut, sc, w_bits=wb, a_bits=ab, group_size=G), reps=3,
                    replays=3)
                l_ms = graph_ms(torch, lambda: torch.matmul(x, w_deq.T))
                b, by = bound_ms(nbytes(ap, wp, lut, sc) + M * N * 4, 2 * M * N * K,
                                 INT8_TC_OPS)
                cfg = f"w{wb}a{ab}" + (f"g{G}" if G else "")
                record("lut_gemm", cfg, M, K, N, err, ok, k_ms, p_ms, l_ms, b, by)
            # dequant_matmul: w2, w2g128, w4 (bf16 activations, as served)
            for wb, G in ((2, None), (2, 128), (4, None)):
                w_idx = codes((N, K), wb)
                wp = packing.pack(w_idx, wb)
                cb = quant.uniform_codebook(wb, device=dev).levels
                sc = torch.rand((N,) if G is None else (N, K // G), generator=gen,
                                device=dev) * 0.1 + 0.01
                got = dequant_matmul_cuda(x, wp, cb, sc, bits=wb, group_size=G)
                torch.cuda.synchronize()
                want = dequant_matmul_plain(x, wp, cb, sc, bits=wb, group_size=G)
                err = (got - want).abs().max().item()
                ok = err == 0.0
                w_full = cb[w_idx.long()] * (sc[:, None] if G is None else
                                            quant.expand_group_scales(sc, G))
                w_deq = w_full.to(torch.bfloat16)
                k_ms = graph_ms(torch, lambda: dequant_matmul_cuda(
                    x, wp, cb, sc, bits=wb, group_size=G))
                p_ms = graph_ms(torch, lambda: dequant_matmul_plain(
                    x, wp, cb, sc, bits=wb, group_size=G), reps=5, replays=5)
                l_ms = graph_ms(torch, lambda: torch.matmul(x, w_deq.T))
                b, by = bound_ms(nbytes(x, wp, cb, sc) + M * N * 4, 2 * M * N * K,
                                 BF16_TC_FLOPS)
                cfg = f"w{wb}a16" + (f"g{G}" if G else "")
                record("dequant_matmul", cfg, M, K, N, err, ok, k_ms, p_ms, l_ms,
                       b, by)
            # lut_gemm_bs_fused: raw activations with an all-zero row (the
            # scale floor) and a row whose amax sits in one element
            xe = x.clone()
            if M >= 4:
                xe[0] = 0
                xe[1] *= 1e-3
                xe[1, K // 3] = 40.0
            cases = [(2, None, "bf16", None), (2, 64, "bf16", None),
                     (4, None, "bf16", None)]
            if (K, N) == (1024, 2816):
                cases += [(2, None, "f32", None)]
                if M == 4:
                    cases += [(2, None, "bf16", "static")]
            for wb, G, xdt, asc_kind in cases:
                xb = xe if xdt == "bf16" else xe.float()
                w_idx = codes((N, K), wb)
                planes = packing.pack_bitplanes_signed(w_idx, wb)
                sc = torch.rand((N,) if G is None else (N, K // G), generator=gen,
                                device=dev) * 0.02 + 0.01
                asc = (torch.full((1, 1), 0.037, device=dev)
                       if asc_kind == "static" else None)
                kw = dict(w_bits=wb, a_bits=8, group_size=G)
                got = lut_gemm_bs_fused_cuda(xb, planes, sc, asc, **kw)
                torch.cuda.synchronize()
                want = lut_gemm_bs_fused_plain(xb, planes, sc, asc, **kw)
                err = (got - want).abs().max().item()
                ok = err == 0.0 if G is None else \
                    err <= TOL_BS_GROUPED * max(1.0, want.abs().max().item())
                w_full = (w_idx.float() - 2 ** (wb - 1)) * (
                    sc[:, None] if G is None else quant.expand_group_scales(sc, G))
                w_deq = w_full.to(torch.bfloat16)
                k_ms = graph_ms(torch, lambda: lut_gemm_bs_fused_cuda(
                    xb, planes, sc, asc, **kw))
                p_ms = graph_ms(torch, lambda: lut_gemm_bs_fused_plain(
                    xb, planes, sc, asc, **kw), reps=3, replays=3)
                l_ms = graph_ms(torch, lambda: torch.matmul(xe, w_deq.T))
                b, by = bound_ms(nbytes(xb, planes, sc, asc) + M * N * 4,
                                 2 * M * N * K, INT8_TC_OPS)
                cfg = f"w{wb}a8_bs" + (f"_g{G}" if G else "") + f" {xdt}" + (
                    " a_sc" if asc is not None else "")
                record("lut_gemm_bs_fused", cfg, M, K, N, err, ok, k_ms, p_ms,
                       l_ms, b, by, bs_tiling("lut_gemm_bs_fused", M, N, K, wb, G))
    # lut_gemm_bs_fused at codeqwen1.5-7b's projection shapes (w2a8_bs)
    for K, N in CODEQWEN_SHAPES:
        for M in CODEQWEN_ROWS:
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            w_idx = codes((N, K), 2)
            planes = packing.pack_bitplanes_signed(w_idx, 2)
            sc = torch.rand((N,), generator=gen, device=dev) * 0.02 + 0.01
            kw = dict(w_bits=2, a_bits=8, group_size=None)
            got = lut_gemm_bs_fused_cuda(x, planes, sc, None, **kw)
            torch.cuda.synchronize()
            want = lut_gemm_bs_fused_plain(x, planes, sc, None, **kw)
            err = (got - want).abs().max().item()
            w_deq = ((w_idx.float() - 2) * sc[:, None]).to(torch.bfloat16)
            del w_idx
            k_ms = graph_ms(torch, lambda: lut_gemm_bs_fused_cuda(
                x, planes, sc, None, **kw))
            p_ms = graph_ms(torch, lambda: lut_gemm_bs_fused_plain(
                x, planes, sc, None, **kw), reps=2, replays=2)
            l_ms = graph_ms(torch, lambda: torch.matmul(x, w_deq.T))
            b, by = bound_ms(nbytes(x, planes, sc) + M * N * 4, 2 * M * N * K,
                             INT8_TC_OPS)
            record("lut_gemm_bs_fused", "w2a8_bs bf16 cq", M, K, N, err,
                   err == 0.0, k_ms, p_ms, l_ms, b, by,
                   bs_tiling("lut_gemm_bs_fused", M, N, K, 2, None))
            del w_deq, planes
    # lut_gemm_bs_fused at the bit-sliced edges (BITSLICED_EDGES), bf16 x
    # with an all-zero row and a row whose amax sits in the last rank's slice
    for label, M, K, N, wb, G in BITSLICED_EDGES:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        if M >= 3:
            x[0] = 0
            x[1] *= 1e-3
            x[1, K - 3] = 40.0
        if label.startswith("worst"):
            x = torch.full((M, K), -1.0, device=dev, dtype=torch.bfloat16)
            w_idx = torch.full((N, K), 2 ** (wb - 1) - 1, device=dev, dtype=torch.uint8)
        else:
            w_idx = codes((N, K), wb)
        planes = packing.pack_bitplanes_signed(w_idx, wb)
        sc = torch.rand((N,) if G is None else (N, K // G), generator=gen,
                        device=dev) * 0.02 + 0.01
        kw = dict(w_bits=wb, a_bits=8, group_size=G)
        got = lut_gemm_bs_fused_cuda(x, planes, sc, None, **kw)
        torch.cuda.synchronize()
        want = lut_gemm_bs_fused_plain(x, planes, sc, None, **kw)
        err = (got - want).abs().max().item()
        ok = err == 0.0 if G is None else \
            err <= TOL_BS_GROUPED * max(1.0, want.abs().max().item())
        w_deq = ((w_idx.float() - 2 ** (wb - 1)) * (
            sc[:, None] if G is None else quant.expand_group_scales(sc, G))
        ).to(torch.bfloat16)
        k_ms = graph_ms(torch, lambda: lut_gemm_bs_fused_cuda(x, planes, sc, None, **kw))
        p_ms = graph_ms(torch, lambda: lut_gemm_bs_fused_plain(x, planes, sc, None, **kw),
                        reps=3, replays=3)
        l_ms = graph_ms(torch, lambda: torch.matmul(x, w_deq.T))
        b, by = bound_ms(nbytes(x, planes, sc) + M * N * 4, 2 * M * N * K, INT8_TC_OPS)
        cfg = f"w{wb}a8_bs" + (f"_g{G}" if G else "") + " edge"
        record("lut_gemm_bs_fused", cfg, M, K, N, err, ok, k_ms, p_ms, l_ms, b, by,
               dict(bs_tiling("lut_gemm_bs_fused", M, N, K, wb, G), label=label))
    return rows


def bs_tiling(op, M, N, K, bits, group):
    """The bit-sliced kernels' tiling at these shapes (bs_partition): MT,
    NT, C, the slice, the blocks and cudaOccupancyMaxActiveClusters."""
    from repro_torch.kernels.lut_gemm_bitsliced import bs_active_clusters, bs_rounds
    (MT, NT, C, kpr), active = bs_active_clusters(op, M, N, K, bits, group)
    return {"MT": MT, "NT": NT, "cluster": C, "k_per_rank": kpr,
            "rounds": bs_rounds(K, C, kpr),
            "blocks": -(-N // NT) * -(-M // MT) * C, "active_clusters": active}


def bs_tiling_text(t):
    return (f"MT {t['MT']} NT {t['NT']} C {t['cluster']} (K/rank {t['k_per_rank']}, "
            f"{t['rounds']} round{'s' if t['rounds'] > 1 else ''}), "
            f"{t['blocks']} blocks, {t['active_clusters']} clusters active at once")


# lut_gemm_bitsliced: the K slices a tp=2 serve gives it (wo 1024 -> 512,
# w_down 2816 -> 1408), and (label, M, K, N, bits, group) edges of both
# bit-sliced kernels (bs_partition's tiles: MT 1/4/8 rows, NT 32-128
# columns, K slices of whole 16-group segments; the "worst case" row has
# every code -128 and every plane pattern 0xF, the widest packed sums)
TP_SLICES = ((512, 1024), (1408, 1024))
BITSLICED_EDGES = (
    ("M 1, K of one pattern group", 1, 4, 16, 2, None),
    ("one group per row", 4, 1024, 256, 2, 1024),
    ("N off the column tile", 4, 1024, 1003, 2, None),
    ("K off the segment", 3, 1412, 64, 4, None),
    ("one pattern group per scale group", 5, 512, 40, 2, 4),
    ("group spans segments", 32, 2048, 72, 4, 512),
    ("M 33, rows off the row tile", 33, 1024, 1024, 2, None),
    ("M 33, g64", 33, 2816, 1024, 4, 64),
    ("ragged last rank", 4, 1984, 1024, 2, 64),
    ("worst case, w4", 4, 1024, 1024, 4, None),
    ("worst case, w2", 4, 1024, 1024, 2, None),
    ("g4 over a long K, several rounds", 4, 13440, 4096, 2, 4),
)


def phase_bitsliced(torch, dev):
    """The two-step lut_gemm_bitsliced against its plain version at qwen's
    projection shapes and the tp=2 K slices (M 1, 4, 32; w2 and w4; per
    channel and g64) and at the edges, with kernel, plain, library and
    bound times."""
    from repro_torch.core import packing, quant
    from repro_torch.kernels.lut_gemm_bitsliced import (lut_gemm_bitsliced_cuda,
                                                        lut_gemm_bitsliced_plain)

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    cases = [("qwen", M, K, N, wb, G) for K, N in SHAPES + TP_SLICES
             for M in ROWS for wb in (2, 4) for G in (None, 64)]
    cases += [("codeqwen", 4, K, N, 2, G) for K, N in CODEQWEN_SHAPES
              for G in (None, 64)]
    cases += [(label, M, K, N, wb, G) for label, M, K, N, wb, G in BITSLICED_EDGES]
    for label, M, K, N, wb, G in cases:
        codes = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
        w_idx = torch.randint(0, 2 ** wb, (N, K), generator=gen, device=dev,
                              dtype=torch.uint8)
        if label.startswith("worst"):
            codes.fill_(-128)
            w_idx.fill_(2 ** (wb - 1) - 1)          # every plane pattern 0xF
        planes = packing.pack_bitplanes_signed(w_idx, wb)
        sc = None if G is None else (
            torch.rand((N, K // G), generator=gen, device=dev) * 0.02 + 0.01)
        kw = dict(w_bits=wb, group_size=G)
        got = lut_gemm_bitsliced_cuda(codes, planes, sc, **kw)
        torch.cuda.synchronize()
        want = lut_gemm_bitsliced_plain(codes, planes, sc, **kw)
        err = (got - want).abs().max().item()
        ok = err == 0.0 if G is None else \
            err <= TOL_BS_GROUPED * max(1.0, want.abs().max().item())
        w_full = (w_idx.float() - 2 ** (wb - 1)) * (
            1.0 if G is None else quant.expand_group_scales(sc, G))
        w_deq, x = w_full.to(torch.bfloat16), codes.to(torch.bfloat16)
        k_ms = graph_ms(torch, lambda: lut_gemm_bitsliced_cuda(codes, planes, sc, **kw))
        p_ms = graph_ms(torch, lambda: lut_gemm_bitsliced_plain(codes, planes, sc, **kw),
                        reps=3, replays=3)
        l_ms = graph_ms(torch, lambda: torch.matmul(x, w_deq.T))
        b, by = bound_ms(nbytes(codes, planes, sc) + M * N * 4, 2 * M * N * K,
                         INT8_TC_OPS)
        cfg = f"w{wb}" + (f"g{G}" if G else "")
        tiling = bs_tiling("lut_gemm_bitsliced", M, N, K, wb, G)
        rows.append({"kernel": "lut_gemm_bitsliced", "cfg": cfg, "label": label,
                     "M": M, "K": K, "N": N, "max_abs_err": err, "ms": k_ms,
                     "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b,
                     "bound_by": by, **tiling})
        print(f"  lut_gemm_bitsliced {label:33s} {cfg:6s} M={M:<3d} K={K:<5d} "
              f"N={N:<5d} err={err:.3g} kernel={k_ms:.5f}ms plain={p_ms:.5f}ms "
              f"library={l_ms:.5f}ms bound={b:.5f}ms ({by}); "
              f"{bs_tiling_text(tiling)}", flush=True)
        if not ok:
            fail(f"lut_gemm_bitsliced {label} {cfg} M={M} K={K} N={N} disagrees "
                 f"with its plain version: max_abs_err={err}")
        del w_full, w_deq
    return {"lut_gemm_bitsliced": rows}


# (label, E, M, K, N, bits, group, zero every 3rd expert's rows)
EXPERT_EDGES = (
    ("E 1", 1, 4, 2048, 1408, 2, None, False),
    ("N off the warp tile", 8, 4, 2048, 1003, 2, None, False),
    ("K off the word step", 8, 4, 1400, 512, 2, None, False),
    ("G 8, two groups per lane word", 4, 4, 2048, 256, 2, 8, False),
    ("one group per row", 4, 4, 2048, 256, 2, 2048, False),
    ("unfilled capacity slots", 64, 4, 2048, 1408, 2, None, True),
)


def phase_experts(torch, dev):
    """The two expert GEMMs against their plain versions: EXPERT_SHAPES at
    w2, w2 g64 and (dequant kernel) w4, then EXPERT_EDGES. Activations are
    bf16 as served; the LUT rows' yardstick multiplies the activation
    levels as bf16."""
    from repro_torch.core import packing, quant
    from repro_torch.core.lut import product_lut
    from repro_torch.kernels import expert_gemm as EG

    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {"expert_dequant_matmul": [], "expert_lut_gemm": []}
    cases = []
    for E, M, K, N in EXPERT_SHAPES:
        label = "moonshot decode" if M == 4 else f"moonshot M {M}"
        cases += [("expert_dequant_matmul", label, E, M, K, N, b, G, False)
                  for b, G in ((2, None), (2, 64), (4, None))]
        cases += [("expert_lut_gemm", label, E, M, K, N, 2, G, False)
                  for G in (None, 64)]
    cases += [(name, *edge) for edge in EXPERT_EDGES for name in rows]
    for name, label, E, M, K, N, bits, G, zero in cases:
        w_idx = torch.randint(0, 2 ** bits, (E, N, K), generator=gen, device=dev,
                              dtype=torch.uint8)
        wp = packing.pack(w_idx, bits)
        levels = quant.uniform_codebook(bits, device=dev).levels
        sc_shape = (E, N) if G is None else (E, N, K // G)
        if name == "expert_dequant_matmul":
            x = torch.randn((E, M, K), generator=gen, device=dev).to(torch.bfloat16)
            if zero:
                x[::3] = 0
            sc = torch.rand(sc_shape, generator=gen, device=dev) * 0.1 + 0.01
            ops, kw = (x, wp, levels, sc), dict(bits=bits, group_size=G)
            w_scale = sc[..., None] if G is None else quant.expand_group_scales(sc, G)
            xb, n_in, peak = x, nbytes(x, levels, sc), BF16_TC_FLOPS
        else:
            a_idx = torch.randint(0, 2 ** bits, (E, M, K), generator=gen, device=dev,
                                  dtype=torch.uint8)
            if zero:
                a_idx[::3] = 2 ** (bits - 1)          # the code of 0.0
            ap = packing.pack(a_idx, bits)
            lut = product_lut(levels, levels).table
            sc = None if G is None else (
                torch.rand(sc_shape, generator=gen, device=dev) * 0.1 + 0.01)
            ops, kw = (ap, wp, lut, sc), dict(w_bits=bits, a_bits=bits,
                                             group_size=G)
            w_scale = 1.0 if G is None else quant.expand_group_scales(sc, G)
            xb = levels[a_idx.long()].to(torch.bfloat16)
            n_in, peak = nbytes(ap, lut, sc), INT8_TC_OPS
        kern, plain = getattr(EG, f"{name}_cuda"), getattr(EG, f"{name}_plain")
        got = kern(*ops, **kw)
        torch.cuda.synchronize()
        want = plain(*ops, **kw)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        exact = name == "expert_dequant_matmul" or G is None
        ok = bool(torch.isfinite(got).all()) and (
            err == 0.0 if exact else err <= TOL_EXPERT_GROUPED * scale)
        zero_ok = not zero or got[::3].abs().max().item() == 0.0
        wdq = (levels[w_idx.long()] * w_scale).to(torch.bfloat16) \
            .transpose(1, 2).contiguous()                      # (E, K, N)
        del w_idx
        k_ms = graph_ms(torch, lambda: kern(*ops, **kw))
        p_ms = graph_ms(torch, lambda: plain(*ops, **kw), reps=2, replays=2)
        l_ms = graph_ms(torch, lambda: torch.bmm(xb, wdq))
        del wdq
        b, by = bound_ms(nbytes(wp) + n_in + E * M * N * 4, 2 * E * M * N * K, peak)
        cfg = f"w{bits}" + ("a16" if name == "expert_dequant_matmul" else f"a{bits}") \
            + (f"g{G}" if G else "")
        rows[name].append({
            "kernel": name, "label": label, "cfg": cfg, "E": E, "M": M, "K": K,
            "N": N, "max_abs_err": err, "max_abs_plain": scale, "ms": k_ms,
            "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b, "bound_by": by})
        print(f"  {name:21s} {label:30s} {cfg:8s} E={E:<2d} M={M:<2d} K={K:<4d} "
              f"N={N:<4d} err={err:.3g} (max|plain| {scale:.3g}) kernel={k_ms:.5f}ms "
              f"plain={p_ms:.5f}ms bmm={l_ms:.5f}ms bound={b:.5f}ms ({by})",
              flush=True)
        if not (ok and zero_ok):
            fail(f"{name} {label} {cfg} disagrees with its plain version: "
                 f"max_abs_err={err}, max|plain|={scale}, zero rows kept zero: "
                 f"{zero_ok}")
    return rows


def attention_operands(torch, dev, gen, *, B, KV, G, hd, bits, bs, lengths, nb,
                       q_dtype):
    """q, a pool whose blocks each sequence owns in a shuffled order, the
    NULL-padded int64 tables and the lengths, all on the card."""
    need = [-(-n // bs) for n in lengths]
    n_blocks = 1 + sum(need) + 2
    ids = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    tables = torch.zeros((B, nb), dtype=torch.int64, device=dev)
    o = 0
    for b, k in enumerate(need):
        tables[b, :k] = ids[o:o + k]
        o += k
    shape = (n_blocks, bs, KV, hd * bits // 8)
    if bits == 8:
        pools = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                               dtype=torch.int8) for _ in range(2)]
    else:
        pools = [torch.randint(0, 256, shape, generator=gen, device=dev,
                               dtype=torch.uint8) for _ in range(2)]
    scs = [torch.rand(shape[:3], generator=gen, device=dev) * 0.045 + 0.005
           for _ in range(2)]
    q = torch.randn((B, KV, G, hd), generator=gen, device=dev).to(q_dtype)
    lens = torch.tensor(lengths, dtype=torch.int64, device=dev)
    return [q, pools[0], scs[0], pools[1], scs[1], tables, lens]


# (label, B, KV, G, hd, bits, bs, lengths, nb, kv_splits, q dtype)
ATTN_ROWS = (
    ("qwen serve", 4, 16, 1, 64, 8, 16, (4, 23, 48, 64), 4, 1, "bf16"),
    ("qwen serve", 4, 16, 1, 64, 8, 16, (4, 23, 48, 64), 4, 2, "bf16"),
    ("codeqwen serve", 4, 32, 1, 128, 4, 16, (4, 23, 48, 64), 4, 1, "bf16"),
    ("codeqwen serve", 4, 32, 1, 128, 4, 16, (4, 23, 48, 64), 4, 2, "bf16"),
    ("long 8k", 2, 16, 1, 64, 8, 512, (8192, 8192), 20, 1, "bf16"),
    ("long 8k", 2, 16, 1, 64, 8, 512, (8192, 8192), 20, 8, "bf16"),
    ("long 32k", 2, 16, 1, 64, 8, 512, (32768, 32768), 68, 1, "bf16"),
    ("long 32k", 2, 16, 1, 64, 8, 512, (32768, 32768), 68, 8, "bf16"),
    ("G=8", 2, 2, 8, 128, 8, 16, (100, 300), 20, 1, "f32"),
    ("G=8", 2, 2, 8, 128, 4, 16, (100, 300), 20, 3, "f32"),
    ("edge len 1", 2, 4, 2, 64, 8, 16, (1, 1), 3, 1, "f32"),
    ("edge len 1, masked chunks", 2, 4, 2, 64, 4, 16, (1, 37), 6, 4, "f32"),
    ("edge off-block, padded", 3, 4, 2, 64, 8, 16, (17, 37, 95), 8, 1, "bf16"),
    ("edge off-block, padded", 3, 4, 2, 64, 4, 16, (17, 37, 95), 8, 3, "bf16"),
    ("edge splits > nb", 2, 4, 2, 64, 8, 16, (3, 40), 3, 7, "f32"),
    ("ragged, ranks past a length", 2, 16, 1, 64, 8, 16, (4999, 700), 313, 1, "bf16"),
)
REPRESENTATIVE_ATTN = {"paged_attention": ("qwen serve", 1),
                       "paged_attention_splitkv": ("long 32k", 8)}


def phase_attention(torch, dev):
    """The paged-attention pair against its plain versions (ATTN_ROWS)."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.ref import dequant_kv_tile

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {"paged_attention": [], "paged_attention_splitkv": []}
    for (label, B, KV, G, hd, bits, bs, lengths, nb, ks, qdt) in ATTN_ROWS:
        q_dtype = torch.bfloat16 if qdt == "bf16" else torch.float32
        ops = attention_operands(torch, dev, gen, B=B, KV=KV, G=G, hd=hd,
                                 bits=bits, bs=bs, lengths=lengths, nb=nb,
                                 q_dtype=q_dtype)
        if ks == 1:
            name = "paged_attention"

            def kern():
                return PA.paged_attention_cuda(*ops, bits=bits)

            def plain():
                return PA.paged_attention_plain(*ops, bits=bits)
        else:
            name = "paged_attention_splitkv"

            def kern():
                return PA.paged_attention_splitkv_cuda(*ops, bits=bits,
                                                       kv_splits=ks)

            def plain():
                return PA.paged_attention_splitkv_plain(*ops, bits=bits,
                                                        kv_splits=ks)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= TOL_ATTN * scale
        k_ms = graph_ms(torch, kern)
        p_ms = graph_ms(torch, plain, reps=3, replays=3)
        # library: SDPA over the pre-dequantized bf16 view (outside the timing)
        q, kp, ksc, vp, vsc, tbl, lens = ops

        def view(pool, sc):
            d = dequant_kv_tile(pool[tbl], sc[tbl], bits)      # (B, nb, bs, KV, hd)
            return d.reshape(B, nb * bs, KV, hd)

        l_ms = sdpa_ms(torch, q, view(kp, ksc), view(vp, vsc), lens, G)
        n_rows = sum(lengths)
        n_bytes = (n_rows * KV * (hd * bits // 8 + 4) * 2 + nbytes(q)
                   + B * KV * G * hd * 4)
        b, by = bound_ms(n_bytes, 4 * n_rows * KV * G * hd, BF16_TC_FLOPS)
        row = {"kernel": name, "label": label, "B": B, "KV": KV, "G": G, "hd": hd,
               "bits": bits, "bs": bs, "lengths": list(lengths), "nb": nb,
               "kv_splits": ks, "q": qdt, "max_abs_err": err, "max_abs_plain": scale,
               "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b,
               "bound_by": by}
        if ks == 1:
            C, active = PA.paged_attention_active_clusters(B, KV, G, hd, bs, nb, bits,
                                                           q_dtype)
            row.update(cluster=C, blocks=B * KV * C, active_clusters=active)
            grid = (f"cluster {C}, {B * KV * C} blocks, {active} clusters active "
                    "at once")
        else:
            ns = PA.split_partition(nb, ks)[0]
            grid = f"{B * KV * ns} blocks + merge"
        rows[name].append(row)
        print(f"  {name:23s} {label:26s} B={B} KV={KV} G={G} hd={hd} int{bits} "
              f"bs={bs} len={list(lengths) if len(set(lengths)) > 1 else lengths[0]} "
              f"nb={nb} splits={ks} q={qdt} err={err:.3g} (max|plain| "
              f"{scale:.3g}) kernel={k_ms:.5f}ms plain={p_ms:.5f}ms "
              f"sdpa={l_ms:.5f}ms bound={b:.5f}ms ({by}); {grid}", flush=True)
        if not ok:
            fail(f"{name} {label} disagrees with its plain version: "
                 f"max_abs_err={err}, max|plain|={scale}")
    return rows


def sdpa_ms(torch, q, kd, vd, lens, G: int) -> float:
    """scaled_dot_product_attention over a dequantized (B, L, KV, hd) view
    in bf16, masked to the lengths (the library yardstick)."""
    import torch.nn.functional as F

    B, L, KV, hd = kd.shape

    def heads(d):
        return d.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).to(
            torch.bfloat16).contiguous()

    k, v = heads(kd), heads(vd)
    qs = q.reshape(B, KV * G, 1, hd).to(torch.bfloat16)
    mask = (torch.arange(L, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    return graph_ms(torch, lambda: F.scaled_dot_product_attention(qs, k, v,
                                                                  attn_mask=mask))


def phase_kv_cache_attention(torch, dev):
    """kv_cache_attention against its plain version (KV_CACHE_ROWS)."""
    from repro_torch.kernels import kv_cache_attention as KA
    from repro_torch.kernels.ref import dequant_kv_tile

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for label, B, KV, G, hd, bits, S, lengths, qdt in KV_CACHE_ROWS:
        shape = (B, S, KV, hd * bits // 8)
        if bits == 8:
            codes = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                                   dtype=torch.int8) for _ in range(2)]
        else:
            codes = [torch.randint(0, 256, shape, generator=gen, device=dev,
                                   dtype=torch.uint8) for _ in range(2)]
        scs = [torch.rand(shape[:3], generator=gen, device=dev) * 0.045 + 0.005
               for _ in range(2)]
        q = torch.randn((B, KV, G, hd), generator=gen, device=dev).to(
            torch.bfloat16 if qdt == "bf16" else torch.float32)
        lens = torch.tensor(lengths, dtype=torch.int64, device=dev)
        ops = (q, codes[0], scs[0], codes[1], scs[1], lens)
        got = KA.kv_cache_attention_cuda(*ops, bits=bits)
        torch.cuda.synchronize()
        want = KA.kv_cache_attention_plain(*ops, bits=bits)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err == 0.0
        k_ms = graph_ms(torch, lambda: KA.kv_cache_attention_cuda(*ops, bits=bits))
        p_ms = graph_ms(torch, lambda: KA.kv_cache_attention_plain(*ops, bits=bits),
                        reps=3, replays=3)
        kd, vd = (dequant_kv_tile(c, sc, bits) for c, sc in zip(codes, scs))
        l_ms = sdpa_ms(torch, q, kd, vd, lens, G)
        del kd, vd
        n_rows = sum(lengths)
        n_bytes = (n_rows * KV * (hd * bits // 8 + 4) * 2 + nbytes(q)
                   + B * KV * G * hd * 4)
        b, by = bound_ms(n_bytes, 4 * n_rows * KV * G * hd, BF16_TC_FLOPS)
        C, active = KA.kv_cache_attention_active_clusters(B, S, KV, G, hd, bits,
                                                           q.dtype)
        rows.append({"kernel": "kv_cache_attention", "label": label, "B": B,
                     "KV": KV, "G": G, "hd": hd, "bits": bits, "S": S,
                     "lengths": list(lengths), "q": qdt, "max_abs_err": err,
                     "max_abs_plain": scale, "ms": k_ms, "plain_ms": p_ms,
                     "library_ms": l_ms, "bound_ms": b, "bound_by": by,
                     "cluster": C, "blocks": B * KV * C, "active_clusters": active})
        print(f"  kv_cache_attention      {label:26s} B={B} KV={KV} G={G} hd={hd} "
              f"int{bits} S={S} len={list(lengths) if len(set(lengths)) > 1 else lengths[0]} "
              f"q={qdt} err={err:.3g} (max|plain| {scale:.3g}) kernel={k_ms:.5f}ms "
              f"plain={p_ms:.5f}ms sdpa={l_ms:.5f}ms bound={b:.5f}ms ({by}); "
              f"cluster {C}, {B * KV * C} blocks, {active} clusters active at once",
              flush=True)
        if not ok:
            fail(f"kv_cache_attention {label} disagrees with its plain version: "
                 f"max_abs_err={err}, max|plain|={scale}")
        del codes, scs
    return {"kv_cache_attention": rows}


def run_engine(torch, serve, cfg, qparams, args, capture: dict, **engine_kw):
    """One serve run through the CLI's code path; checks every decode
    step's logits are finite and keeps the first step's."""
    engine = serve.make_engine(cfg, qparams, args, **engine_kw)
    inner = engine._decode_fn

    def checked(*a):
        logits = inner(*a)
        if not bool(torch.isfinite(logits).all()):
            fail(f"{cfg.name} {cfg.quant} produced non-finite logits")
        capture.setdefault("first_logits", logits.clone())
        return logits

    engine._decode_fn = checked
    res = serve.serve_paged(cfg, qparams, args, engine=engine)
    if not all(r.done for r in res["requests"]):
        fail("not every request finished")
    res["weight_bytes"] = res.pop("engine").per_device_weight_bytes()
    return res


def profile_steps(torch, step, steps: int, label: str) -> dict:
    """torch.profiler over ``steps`` calls of ``step``: wall and device-busy
    time per step (the idle share), kernels per step, device ms per step by
    kernel name, and the top host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
    by_dev: dict = {}
    for e in dev:
        by_dev[e.name] = by_dev.get(e.name, 0.0) + e.time_range.elapsed_us()
    top_dev = sorted(by_dev.items(), key=lambda kv: -kv[1])[:5]
    top_cpu = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:6]
    # kernel families by name: paged_attn_ is the paged single pass
    # (paged_attn_cluster_kernel) and the split (paged_attn_split_kernel)
    fam_ms = {k: sum(us for n, us in by_dev.items() if k in n) / 1e3 / steps
              for k in ("paged_attn_", "merge_kernel", "kv_cache_attn_kernel",
                        "expert_dequant_kernel", "expert_lut_kernel")}
    attn_ms = {k: fam_ms[k] for k in ("paged_attn_", "merge_kernel",
                                      "kv_cache_attn_kernel")}
    expert_ms = fam_ms["expert_dequant_kernel"] + fam_ms["expert_lut_kernel"]
    out = {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "kernels_per_step": len(dev) / steps,
           "attention_device_ms_per_step": attn_ms,
           "expert_device_ms_per_step": expert_ms,
           "top_device_ms_per_step": [(n[:60], us / 1e3 / steps) for n, us in top_dev],
           "top_host_self_ms_per_step": [(a.key[:60], a.self_cpu_time_total / 1e3 / steps)
                                         for a in top_cpu]}
    print(f"{label}, {steps} steps: wall {wall_ms:.2f} ms/step, device busy "
          f"{busy_ms:.2f} ms/step (idle share {out['idle_share']:.3f}), "
          f"{out['kernels_per_step']:.0f} kernels/step, attention kernels "
          f"{attn_ms['paged_attn_']:.3f} ms/step (+ merge "
          f"{attn_ms['merge_kernel']:.3f}; dense-cache "
          f"{attn_ms['kv_cache_attn_kernel']:.3f}), expert kernels "
          f"{expert_ms:.3f} ms/step", flush=True)
    print("  top device: " + "; ".join(f"{n} {ms:.3f}ms" for n, ms in
                                       out["top_device_ms_per_step"]), flush=True)
    print("  top host (self): " + "; ".join(f"{n} {ms:.3f}ms" for n, ms in
                                            out["top_host_self_ms_per_step"]),
          flush=True)
    return out


def phase_profile(torch, serve, cfg, qparams, args, label: str,
                  steps: int = 4) -> dict:
    """Profile ``steps`` engine steps of the serve workload, taken once
    the first requests decode (a mix of decode and prefill-chunk steps,
    as served)."""
    engine = serve.make_engine(cfg, qparams, args)
    for r in serve.make_requests(cfg, args):
        engine.submit(r)
    while engine.decode_steps < 4:
        engine.step()
    return profile_steps(torch, engine.step, steps, label)


def rel_diff(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def plant_long_context(torch, engine, ctx: int, steps: int, seed: int) -> list:
    """Set each slot decode-ready at pos = ctx, its blocks allocated as
    admission would, over pools filled from a seeded generator on the card
    (benchmarks/serving.py's planted long-context state). The same seed
    gives byte-identical pools and tables. The K/V rows are drawn from
    N(0, 1) and stored through the pool's own codec (layers.KV_QUANT), as
    the engine stores the rows it computes; benchmarks/serving.py fills
    uniform codes and N(0, 0.05^2) scales instead, which no codec writes."""
    import numpy as np

    from repro_torch.models.layers import KV_QUANT
    from repro_torch.serving.engine import _DECODE, Request

    gen = torch.Generator(device=engine.device).manual_seed(seed)
    cfg = engine.cfg
    for layer in engine.caches:
        for name in ("k", "v"):
            x = torch.randn(layer[name].shape[:3] + (cfg.hd,), generator=gen,
                            device=engine.device)
            codes, sc = KV_QUANT[cfg.kv_cache_dtype][0](x)
            layer[name].copy_(codes)
            layer[f"{name}_sc"].copy_(sc)
            del x, codes, sc
    rng = np.random.default_rng(seed)
    reqs = []
    for i, s in enumerate(engine.slots):
        r = Request(uid=i, prompt=np.zeros((1,), np.int64), max_new=steps)
        s.req, s.state, s.prompt, s.pos = r, _DECODE, np.zeros((1,), np.int64), ctx
        s.next_input = int(rng.integers(0, cfg.vocab_size))
        s.blocks = engine.pool.alloc(ctx // engine.block_size + 1)
        reqs.append(r)
    return reqs


ATTN_OPS = ("paged_attention", "paged_attention_splitkv", "kv_cache_attention")


def checked_attention_calls(errs: list):
    """While active, every attention op the registry sends to its kernel is
    also run through its plain version on the same inputs (no launch), and
    max|kernel - plain| / max|plain| of each call is appended to ``errs``."""
    from repro_torch.kernels import registry
    return registry.checked_against_plain(ATTN_OPS, errs)


def fixed_run(torch, serve, cfg, qparams, args, attn_backend: str = "auto",
              call_errs: list | None = None) -> dict:
    """One fixed-batch serve through the CLI's code path (``serve_fixed``);
    checks every decode step's logits are finite. With ``call_errs`` the
    first decode step runs with every attention call checked against its
    plain version."""
    from repro_torch.launch import steps as St

    inner = St.make_decode_step(cfg, attn_backend=attn_backend)
    done = []

    def decode(params, caches, batch):
        check = call_errs is not None and not done
        with checked_attention_calls(call_errs) if check else contextlib.nullcontext():
            logits, caches = inner(params, caches, batch)
        done.append(1)
        if not bool(torch.isfinite(logits).all()):
            fail(f"{cfg.name} {cfg.quant} produced non-finite logits")
        return logits, caches

    return serve.serve_fixed(cfg, qparams, args, decode_step=decode)


def fixed_profile(torch, cfg, qparams, args, label: str, steps: int = 4) -> dict:
    """Profile ``steps`` decode steps of the fixed loop, after its prefill
    and one decode step."""
    from repro_torch.launch import steps as St

    B, P = args.batch, args.prompt_len
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    decode = St.make_decode_step(cfg)
    logits, caches = St.make_prefill_step(cfg, max_len=P + args.gen)(
        qparams, {"tokens": tokens})
    state = {"tok": logits[:, -1].argmax(-1), "pos": P, "caches": caches}

    def step():
        pos = torch.full((B,), state["pos"], dtype=torch.int64, device="cuda")
        lg, state["caches"] = decode(qparams, state["caches"],
                                     {"tokens": state["tok"][:, None], "pos": pos})
        state["tok"], state["pos"] = lg[:, -1].argmax(-1), state["pos"] + 1

    step()
    return profile_steps(torch, step, steps, label)


def long_context_run(torch, cfg, qparams, ctx: int, kv_splits: int, wrappers,
                     attn_backend: str = "auto", warm: int = LC_WARM,
                     gen_steps: int = LC_GEN, profile: bool = True) -> dict:
    """Planted decode at ``ctx``: ``warm`` warm-up steps, the first with
    every attention call checked against its plain version, ``gen_steps``
    timed steps (host clock around synchronised steps), then 2 profiled
    steps; launch counts set to 0 just before and read just after."""
    from repro_torch.serving import Engine

    engine = Engine(cfg, qparams, n_slots=LC_SLOTS, max_len=ctx + 4 * LC_BLOCK,
                    block_size=LC_BLOCK, chunk_size=LC_BLOCK, kv_splits=kv_splits,
                    attn_backend=attn_backend)
    n_prof = 2 if profile else 0
    reqs = plant_long_context(torch, engine, ctx, warm + gen_steps + n_prof,
                              seed=11)
    cap: dict = {}
    inner = engine._decode_fn

    def checked(*a):
        logits = inner(*a)
        if not bool(torch.isfinite(logits).all()):
            fail(f"long context {ctx} kv_splits {kv_splits} produced non-finite "
                 "logits")
        cap.setdefault("first_logits", logits.clone())
        return logits

    engine._decode_fn = checked
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    call_errs: list = []
    with checked_attention_calls(call_errs):
        engine._do_decode()
    for _ in range(warm - 1):
        engine._do_decode()
    times = []
    for _ in range(gen_steps):
        t0 = time.perf_counter()
        engine._do_decode()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prof = profile_steps(torch, engine._do_decode, n_prof,
                         f"[8 long] ctx {ctx} kv_splits {kv_splits} profile") \
        if profile else None
    launches = {name: w.launches for name, w in wrappers.items()}
    out = {"steps": engine.decode_steps, "launches": launches,
           "first_step_call_errs": call_errs,
           "decode_step_ms": 1e3 * sum(times) / len(times) if times else None,
           "tokens": [r.out for r in reqs], "first_logits": cap["first_logits"],
           "profile": prof}
    del engine
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a card")
    if not (SRC / "repro_torch" / "kernels" / "build.py").exists():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.expert_gemm import (expert_dequant_matmul_cuda,
                                                 expert_lut_gemm_cuda)
    from repro_torch.kernels.kv_cache_attention import kv_cache_attention_cuda
    from repro_torch.kernels.lut_dequant_matmul import dequant_matmul_cuda
    from repro_torch.kernels.lut_gemm import lut_gemm_cuda
    from repro_torch.kernels.lut_gemm_bitsliced import (lut_gemm_bitsliced_cuda,
                                                        lut_gemm_bs_fused_cuda)
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_splitkv_cuda)
    from repro_torch.launch import mesh, serve
    from repro_torch.models import lm

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[1 device] {kind} x{count} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[2 settings] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    built = build.build()
    print(f"[3 build] nvcc sm_90a, {sum(r['built'] for r in built.values())} "
          f"of {len(built)} sources built in parallel, "
          f"{time.perf_counter() - t0:.1f}s wall", flush=True)
    for stem, rec in sorted(built.items()):
        how = f"{rec['seconds']:.1f}s" if rec["built"] else "already built"
        print(f"  {stem}.cu: {how}", flush=True)
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}", flush=True)

    print("[4 kernels] kernel vs plain at the serving shapes "
          f"(tolerances: lut_gemm exact / grouped {TOL_LUT_GROUPED} rel, "
          f"dequant_matmul exact, lut_gemm_bs_fused and lut_gemm_bitsliced exact "
          f"/ grouped {TOL_BS_GROUPED} rel, paged attention {TOL_ATTN} rel, "
          "kv_cache_attention exact, "
          f"expert_lut_gemm exact / grouped {TOL_EXPERT_GROUPED} rel, "
          "expert_dequant_matmul exact)", flush=True)
    rows = phase_kernels(torch, dev)
    rows.update(phase_bitsliced(torch, dev))
    rows.update(phase_attention(torch, dev))
    rows.update(phase_kv_cache_attention(torch, dev))
    rows.update(phase_experts(torch, dev))
    print(f"[4 kernels] done at {time.perf_counter() - t_start:.1f}s", flush=True)

    gemms = {"lut_gemm": lut_gemm_cuda, "dequant_matmul": dequant_matmul_cuda,
             "lut_gemm_bs_fused": lut_gemm_bs_fused_cuda,
             "lut_gemm_bitsliced": lut_gemm_bitsliced_cuda,
             "expert_dequant_matmul": expert_dequant_matmul_cuda,
             "expert_lut_gemm": expert_lut_gemm_cuda}
    attns = {"paged_attention": paged_attention_cuda,
             "paged_attention_splitkv": paged_attention_splitkv_cuda,
             "kv_cache_attention": kv_cache_attention_cuda}
    wrappers = {**gemms, **attns}
    plan_op = {"w2a2": "lut_gemm", "w2a16": "dequant_matmul",
               "w2a8_bs": "lut_gemm_bs_fused"}

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def expect_launches(what, launches, counts: dict):
        """The named wrappers launched exactly ``counts``, the others 0."""
        want = {name: counts.get(name, 0) for name in wrappers}
        if launches != want:
            fail(f"{what}: launches {launches}, expected {want}")

    results = {}
    for plan, op in plan_op.items():
        args = serve.build_parser().parse_args(
            ["--arch", "qwen1.5-0.5b", "--paged", "--plan", plan,
             "--device", "cuda"])
        cfg, qparams = serve.prepare(args)
        cap_k: dict = {}
        reset_launches()
        res_k = run_engine(torch, serve, cfg, qparams, args, cap_k)
        launches = {name: w.launches for name, w in wrappers.items()}
        m = res_k["metrics"]
        forwards = m["decode_steps"] + m["prefill_chunks"]
        print(f"[5 engine] {cfg.name} {plan} (int8 pool, full width): "
              f"{len(res_k['requests'])} requests, {res_k['tokens']} tokens, "
              f"{res_k['tok_per_s']:.1f} tok/s, decode-only step "
              f"{res_k['decode_step_ms']:.3f} ms on {smi} | launches {launches} "
              f"over {forwards} forwards, {m['decode_steps']} decode steps",
              flush=True)
        expect_launches(plan, launches, {op: 7 * cfg.n_layers * forwards,
                                         "paged_attention": cfg.n_layers * m["decode_steps"]})
        if plan == "w2a8_bs":         # phase 13's single-rank reference
            tp1_bs = {"tokens": [r.out for r in res_k["requests"]],
                      "first_logits": cap_k["first_logits"].cpu(),
                      "packed_bytes": {p: qw.packed.numel() * qw.packed.element_size()
                                       for p, qw in lm.qweights(qparams).items()},
                      "weight_bytes": res_k["weight_bytes"]}

        # 6: the same run with the registry's GEMMs forced onto the plain
        # versions; attention stays on its kernel
        cfg_p = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, backend="ref"))
        cap_p: dict = {}
        reset_launches()
        res_p = run_engine(torch, serve, cfg_p, qparams, args, cap_p)
        if any(gemms[name].launches for name in gemms):
            fail("the plain-GEMM run launched a GEMM kernel")
        toks_k = [r.out for r in res_k["requests"]]
        toks_p = [r.out for r in res_p["requests"]]
        same = sum(a == b for a, b in zip(toks_k, toks_p))
        rel = rel_diff(cap_k["first_logits"], cap_p["first_logits"])
        print(f"[6 plain] {plan}: plain-GEMM run {res_p['tok_per_s']:.1f} "
              f"tok/s; greedy tokens identical for {same}/{len(toks_k)} "
              f"requests; first decode step logits max rel diff {rel:.3g}",
              flush=True)
        if plan in ("w2a2", "w2a8_bs") and (same != len(toks_k) or rel != 0.0):
            fail(f"{plan}: kernel and plain paths differ (tokens identical for "
                 f"{same}/{len(toks_k)} requests, first-step logits by {rel})")
        if plan == "w2a16" and rel > TOL_LOGITS:
            fail(f"w2a16 first-step logits differ by {rel} > {TOL_LOGITS}")

        # 6: GEMM kernels on, attention on its plain version
        cap_a: dict = {}
        reset_launches()
        res_a = run_engine(torch, serve, cfg, qparams, args, cap_a,
                           attn_backend="ref")
        ma = res_a["metrics"]
        expect_launches(f"{plan} attention-plain run",
                        {name: w.launches for name, w in wrappers.items()},
                        {op: 7 * cfg.n_layers * (ma["decode_steps"] + ma["prefill_chunks"])})
        same_a = sum(a == r.out for a, r in zip(toks_k, res_a["requests"]))
        rel_a = rel_diff(cap_k["first_logits"], cap_a["first_logits"])
        print(f"[6 plain] {plan}: attention-plain run {res_a['tok_per_s']:.1f} "
              f"tok/s; greedy tokens identical for {same_a}/{len(toks_k)} "
              f"requests; first decode step logits max rel diff {rel_a:.3g}",
              flush=True)
        if rel_a > TOL_LOGITS:
            fail(f"{plan}: attention kernel and plain first-step logits differ "
                 f"by {rel_a} > {TOL_LOGITS}")
        results[plan] = {"launches": launches, "tok_per_s": res_k["tok_per_s"],
                         "decode_step_ms": res_k["decode_step_ms"],
                         "plain_tok_per_s": res_p["tok_per_s"],
                         "plain_decode_step_ms": res_p["decode_step_ms"],
                         "tokens_identical": same, "logits_rel_diff": rel,
                         "attn_plain_decode_step_ms": res_a["decode_step_ms"],
                         "attn_plain_tokens_identical": same_a,
                         "attn_plain_logits_rel_diff": rel_a,
                         "profile": phase_profile(torch, serve, cfg, qparams, args,
                                                  f"[7 profile] {plan}")}
    del res_k, res_p, res_a, cap_k, cap_p, cap_a

    # 8: planted long-context decode, qwen1.5-0.5b under w2a8_bs
    print(f"[8 long] started at {time.perf_counter() - t_start:.1f}s", flush=True)
    long_ctx = {}
    for ctx in LC_CONTEXTS:
        split = long_context_run(torch, cfg, qparams, ctx, LC_SPLITS, wrappers)
        single = long_context_run(torch, cfg, qparams, ctx, 1, wrappers)
        ref = long_context_run(torch, cfg, qparams, ctx, LC_SPLITS, wrappers,
                               attn_backend="ref", warm=1, gen_steps=0,
                               profile=False)
        n = cfg.n_layers
        expect_launches(f"ctx {ctx} split", split["launches"],
                        {"lut_gemm_bs_fused": 7 * n * split["steps"],
                         "paged_attention_splitkv": n * split["steps"]})
        expect_launches(f"ctx {ctx} single", single["launches"],
                        {"lut_gemm_bs_fused": 7 * n * single["steps"],
                         "paged_attention": n * single["steps"]})
        expect_launches(f"ctx {ctx} attention-plain", ref["launches"],
                        {"lut_gemm_bs_fused": 7 * n * ref["steps"]})
        call_err = max(split["first_step_call_errs"] + single["first_step_call_errs"])
        n_calls = len(split["first_step_call_errs"]) + len(single["first_step_call_errs"])
        if n_calls != 2 * n or call_err > TOL_ATTN:
            fail(f"ctx {ctx}: {n_calls} checked attention calls (want {2 * n}), "
                 f"max rel err {call_err} > {TOL_ATTN}")
        rel_s = rel_diff(split["first_logits"], single["first_logits"])
        rel_r = rel_diff(split["first_logits"], ref["first_logits"])
        same = sum(a == b for a, b in zip(split["tokens"], single["tokens"]))
        same_r = sum(a[:1] == b[:1] for a, b in zip(split["tokens"], ref["tokens"]))
        print(f"[8 long] ctx {ctx}: the first step's {n_calls} attention kernel "
              f"calls each within {call_err:.3g} of their plain version "
              f"(relative to max|plain|)", flush=True)
        print(f"[8 long] ctx {ctx}, {LC_SLOTS} slots, w2a8_bs: decode-only step "
              f"{split['decode_step_ms']:.3f} ms (kv_splits {LC_SPLITS}) / "
              f"{single['decode_step_ms']:.3f} ms (kv_splits 1); attention "
              f"kernels {split['profile']['attention_device_ms_per_step']} / "
              f"{single['profile']['attention_device_ms_per_step']} ms/step; "
              f"first-step logits split vs single {rel_s:.3g}, split kernel vs "
              f"plain {rel_r:.3g}; tokens identical split vs single for "
              f"{same}/{LC_SLOTS} slots over {split['steps']} steps, first token "
              f"kernel vs plain {same_r}/{LC_SLOTS}", flush=True)
        if rel_s > TOL_LOGITS or rel_r > TOL_LOGITS:
            fail(f"ctx {ctx}: first-step logits differ (split vs single {rel_s}, "
                 f"split vs plain {rel_r}) > {TOL_LOGITS}")
        long_ctx[ctx] = {
            "split_decode_step_ms": split["decode_step_ms"],
            "single_decode_step_ms": single["decode_step_ms"],
            "split_profile": split["profile"], "single_profile": single["profile"],
            "split_launches": split["launches"], "single_launches": single["launches"],
            "logits_rel_diff_split_single": rel_s,
            "logits_rel_diff_split_plain": rel_r,
            "first_step_attention_call_max_rel_err": call_err,
            "tokens_identical_split_single": same}
        del split, single, ref
    # conditioning of the logits gate: two plain formulations (single
    # pass, split) on the same planted state
    ctx = LC_CONTEXTS[-1]
    one = [long_context_run(torch, cfg, qparams, ctx, ks, wrappers,
                            attn_backend="ref", warm=1, gen_steps=0,
                            profile=False)["first_logits"]
           for ks in (1, LC_SPLITS)]
    long_ctx["plain_single_vs_plain_split"] = rel_diff(one[1], one[0])
    print(f"[8 long] ctx {ctx}: first-step logits of the plain single pass vs "
          f"the plain split differ by "
          f"{long_ctx['plain_single_vs_plain_split']:.3g} of max|logit| (not a "
          "gate: it shows how far last-ulp differences in attention can move "
          "this quantized model's logits)", flush=True)
    del one
    results["long_context"] = long_ctx

    # 9: codeqwen1.5-7b at full width, int4 pool, w2a8_bs
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[9 codeqwen] started at {time.perf_counter() - t_start:.1f}s", flush=True)
    args = serve.build_parser().parse_args(
        ["--arch", "codeqwen1.5-7b", "--paged", "--plan", "w2a8_bs", "--device",
         "cuda"])
    cfg, qparams = serve.prepare(args)
    cap_k = {}
    reset_launches()
    res_k = run_engine(torch, serve, cfg, qparams, args, cap_k)
    launches = {name: w.launches for name, w in wrappers.items()}
    m = res_k["metrics"]
    forwards = m["decode_steps"] + m["prefill_chunks"]
    print(f"[9 codeqwen] {cfg.name} w2a8_bs (int4 pool, {cfg.n_layers} layers, "
          f"full width): {len(res_k['requests'])} requests, {res_k['tokens']} "
          f"tokens, {res_k['tok_per_s']:.1f} tok/s, decode-only step "
          f"{res_k['decode_step_ms']:.3f} ms | launches {launches} over "
          f"{forwards} forwards, {m['decode_steps']} decode steps", flush=True)
    expect_launches("codeqwen", launches,
                    {"lut_gemm_bs_fused": 7 * cfg.n_layers * forwards,
                     "paged_attention": cfg.n_layers * m["decode_steps"]})
    cap_a = {}
    reset_launches()
    res_a = run_engine(torch, serve, cfg, qparams, args, cap_a, attn_backend="ref")
    ma = res_a["metrics"]
    expect_launches("codeqwen attention-plain run",
                    {name: w.launches for name, w in wrappers.items()},
                    {"lut_gemm_bs_fused":
                     7 * cfg.n_layers * (ma["decode_steps"] + ma["prefill_chunks"])})
    same_a = sum(a.out == b.out for a, b in zip(res_k["requests"], res_a["requests"]))
    rel_a = rel_diff(cap_k["first_logits"], cap_a["first_logits"])
    print(f"[9 codeqwen] attention-plain run {res_a['tok_per_s']:.1f} tok/s; "
          f"greedy tokens identical for {same_a}/{len(res_k['requests'])} "
          f"requests; first decode step logits max rel diff {rel_a:.3g}", flush=True)
    if rel_a > TOL_LOGITS:
        fail(f"codeqwen: attention kernel and plain first-step logits differ by "
             f"{rel_a} > {TOL_LOGITS}")
    results["codeqwen"] = {
        "launches": launches, "tok_per_s": res_k["tok_per_s"],
        "decode_step_ms": res_k["decode_step_ms"],
        "attn_plain_decode_step_ms": res_a["decode_step_ms"],
        "attn_plain_tokens_identical": same_a, "attn_plain_logits_rel_diff": rel_a,
        "profile": phase_profile(torch, serve, cfg, qparams, args,
                                 "[9 codeqwen profile] w2a8_bs")}

    # 10: moonshot-v1-16b-a3b at full width, int8 pool, w2a2 and w2a16
    del qparams, res_k, res_a, cap_k, cap_a
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[10 moe] started at {time.perf_counter() - t_start:.1f}s", flush=True)
    moe_ops = {"w2a2": ("expert_lut_gemm", "lut_gemm"),
               "w2a16": ("expert_dequant_matmul", "dequant_matmul")}
    moe = {}
    for plan, (eop, dop) in moe_ops.items():
        args = serve.build_parser().parse_args(
            ["--arch", "moonshot-v1-16b-a3b", "--paged", "--plan", plan,
             "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9     # held before packing
        t0 = time.perf_counter()
        cfg, qparams = serve.prepare(args)
        pack_s = time.perf_counter() - t0
        packed_gb = torch.cuda.memory_allocated() / 1e9 - base_gb
        pack_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n, E = cfg.n_layers, cfg.moe.n_experts
        cap_k = {}
        reset_launches()
        res_k = run_engine(torch, serve, cfg, qparams, args, cap_k)
        launches = {name: w.launches for name, w in wrappers.items()}
        m = res_k["metrics"]
        forwards = m["decode_steps"] + m["prefill_chunks"]
        print(f"[10 moe] {cfg.name} {plan} ({n} layers, {E} experts top-"
              f"{cfg.moe.top_k}, int8 pool, full width): {len(res_k['requests'])} "
              f"requests, {res_k['tokens']} tokens, {res_k['tok_per_s']:.1f} tok/s, "
              f"decode-only step {res_k['decode_step_ms']:.3f} ms on {smi} | "
              f"launches {launches} over {forwards} forwards, {m['decode_steps']} "
              f"decode steps | drawn and packed in {pack_s:.1f}s, packed "
              f"{packed_gb:.2f} GB on top of {base_gb:.2f} GB held before, "
              f"peak while packing {pack_peak_gb:.2f} GB", flush=True)
        expect_launches(f"moonshot {plan}", launches,
                        {eop: 3 * n * forwards, dop: 7 * n * forwards,
                         "paged_attention": n * m["decode_steps"]})
        cfg_p = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, backend="ref"))
        cap_p = {}
        reset_launches()
        res_p = run_engine(torch, serve, cfg_p, qparams, args, cap_p)
        if any(gemms[name].launches for name in gemms):
            fail(f"moonshot {plan}: the plain-GEMM run launched a GEMM kernel")
        toks_k = [r.out for r in res_k["requests"]]
        same = sum(a == r.out for a, r in zip(toks_k, res_p["requests"]))
        rel = rel_diff(cap_k["first_logits"], cap_p["first_logits"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"[10 moe] {plan}: plain-GEMM run {res_p['tok_per_s']:.1f} tok/s; "
              f"greedy tokens identical for {same}/{len(toks_k)} requests; first "
              f"decode step logits max rel diff {rel:.3g}; peak device memory "
              f"{peak_gb:.2f} GB", flush=True)
        if plan == "w2a2" and (same != len(toks_k) or rel != 0.0):
            fail(f"moonshot w2a2: kernel and plain paths differ (tokens identical "
                 f"for {same}/{len(toks_k)} requests, first-step logits by {rel})")
        if plan == "w2a16" and rel > TOL_LOGITS:
            fail(f"moonshot w2a16 first-step logits differ by {rel} > {TOL_LOGITS}")
        moe[plan] = {
            "launches": launches, "tok_per_s": res_k["tok_per_s"],
            "decode_step_ms": res_k["decode_step_ms"],
            "plain_tok_per_s": res_p["tok_per_s"],
            "plain_decode_step_ms": res_p["decode_step_ms"],
            "tokens_identical": same, "logits_rel_diff": rel,
            "pack_s": pack_s, "base_gb": base_gb, "packed_gb": packed_gb,
            "pack_peak_gb": pack_peak_gb,
            "peak_gb": peak_gb,
            "profile": phase_profile(torch, serve, cfg, qparams, args,
                                     f"[10 moe profile] {plan}")}
        del qparams, res_k, res_p, cap_k, cap_p
        gc.collect()
        torch.cuda.empty_cache()
    results["moonshot"] = moe

    # 11: the fixed-batch loop at full width and depth
    print(f"[11 fixed] started at {time.perf_counter() - t_start:.1f}s", flush=True)
    fixed = {}
    for arch, plan, op in FIXED_RUNS:
        args = serve.build_parser().parse_args(
            ["--arch", arch, "--plan", plan, "--device", "cuda"])
        cfg, qparams = serve.prepare(args)
        n, B, gen = cfg.n_layers, args.batch, args.gen
        what = f"{arch} {plan} ({cfg.kv_cache_dtype} cache)"
        call_errs: list = []
        reset_launches()
        res_k = fixed_run(torch, serve, cfg, qparams, args, call_errs=call_errs)
        launches = {name: w.launches for name, w in wrappers.items()}
        print(f"[11 fixed] {what}, B {B} x P {args.prompt_len}, gen {gen}: prefill "
              f"{res_k['prefill_ms']:.1f} ms, decode {res_k['tok_per_s']:.1f} tok/s, "
              f"decode-only step {res_k['decode_step_ms']:.3f} ms on {smi} | "
              f"launches {launches}", flush=True)
        expect_launches(f"fixed {what}", launches,
                        {op: 7 * n * gen, "kv_cache_attention": n * (gen - 1)})
        if len(call_errs) != n or max(call_errs) != 0.0:
            fail(f"fixed {what}: {len(call_errs)} checked attention calls (want "
                 f"{n}), max rel err {max(call_errs, default=None)} (want 0)")
        cfg_p = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, backend="ref"))
        reset_launches()
        res_p = fixed_run(torch, serve, cfg_p, qparams, args)
        if any(gemms[name].launches for name in gemms):
            fail(f"fixed {what}: the plain-GEMM run launched a GEMM kernel")
        same = int((res_k["tokens"] == res_p["tokens"]).all(axis=1).sum())
        rel = rel_diff(res_k["first_logits"], res_p["first_logits"])
        reset_launches()
        res_a = fixed_run(torch, serve, cfg, qparams, args, attn_backend="ref")
        expect_launches(f"fixed {what} attention-plain run",
                        {name: w.launches for name, w in wrappers.items()},
                        {op: 7 * n * gen})
        same_a = int((res_k["tokens"] == res_a["tokens"]).all(axis=1).sum())
        rel_a = rel_diff(res_k["first_logits"], res_a["first_logits"])
        print(f"[11 fixed] {what}: the first decode step's {len(call_errs)} "
              f"kv_cache_attention calls each within {max(call_errs):.3g} of their "
              "plain version (relative to max|plain|); plain-GEMM run "
              f"{res_p['tok_per_s']:.1f} tok/s, tokens "
              f"identical for {same}/{B} rows, first-step logits max rel diff "
              f"{rel:.3g}; attention-plain run {res_a['tok_per_s']:.1f} tok/s, "
              f"tokens identical for {same_a}/{B} rows, logits {rel_a:.3g}",
              flush=True)
        if plan != "w2a16" and (same != B or rel != 0.0):
            fail(f"fixed {what}: kernel and plain paths differ (tokens identical "
                 f"for {same}/{B} rows, first-step logits by {rel})")
        if plan == "w2a16" and rel > TOL_LOGITS:
            fail(f"fixed {what}: first-step logits differ by {rel} > {TOL_LOGITS}")
        if rel_a > TOL_LOGITS:
            fail(f"fixed {what}: attention kernel and plain first-step logits "
                 f"differ by {rel_a} > {TOL_LOGITS}")
        fixed[f"{arch} {plan}"] = {
            "launches": launches, "prefill_ms": res_k["prefill_ms"],
            "tok_per_s": res_k["tok_per_s"], "decode_step_ms": res_k["decode_step_ms"],
            "first_step_attention_call_max_rel_err": max(call_errs),
            "plain_tok_per_s": res_p["tok_per_s"], "tokens_identical": same,
            "logits_rel_diff": rel, "attn_plain_decode_step_ms": res_a["decode_step_ms"],
            "attn_plain_tokens_identical": same_a, "attn_plain_logits_rel_diff": rel_a,
            "profile": fixed_profile(torch, cfg, qparams, args,
                                     f"[11 fixed profile] {arch} {plan}")}
        del qparams, res_k, res_p, res_a
        gc.collect()
        torch.cuda.empty_cache()
    results["fixed"] = fixed

    # 12: moonshot-v1-16b-a3b under the grouped w2a2g64 plan, fixed loop
    print(f"[12 moe g64] started at {time.perf_counter() - t_start:.1f}s", flush=True)
    args = serve.build_parser().parse_args(
        ["--arch", "moonshot-v1-16b-a3b", "--plan", "w2a2g64", "--device", "cuda"])
    cfg, qparams = serve.prepare(args)
    n, B, gen = cfg.n_layers, args.batch, args.gen
    reset_launches()
    res_k = fixed_run(torch, serve, cfg, qparams, args)
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"[12 moe g64] {cfg.name} w2a2g64, B {B} x P {args.prompt_len}, gen {gen}: "
          f"prefill {res_k['prefill_ms']:.1f} ms, decode {res_k['tok_per_s']:.1f} "
          f"tok/s, decode-only step {res_k['decode_step_ms']:.3f} ms | launches "
          f"{launches}", flush=True)
    expect_launches("moonshot w2a2g64 fixed", launches,
                    {"expert_lut_gemm": 3 * n * gen, "lut_gemm": 7 * n * gen,
                     "kv_cache_attention": n * (gen - 1)})
    cfg_p = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend="ref"))
    reset_launches()
    res_p = fixed_run(torch, serve, cfg_p, qparams, args)
    if any(gemms[name].launches for name in gemms):
        fail("moonshot w2a2g64: the plain-GEMM run launched a GEMM kernel")
    same = int((res_k["tokens"] == res_p["tokens"]).all(axis=1).sum())
    rel = rel_diff(res_k["first_logits"], res_p["first_logits"])
    print(f"[12 moe g64] plain-GEMM run {res_p['tok_per_s']:.1f} tok/s; greedy tokens "
          f"identical for {same}/{B} rows; first decode step logits max rel diff "
          f"{rel:.3g}", flush=True)
    if same != B or rel > TOL_LOGITS:
        fail(f"moonshot w2a2g64: kernel and plain paths differ (tokens identical "
             f"for {same}/{B} rows, first-step logits by {rel} of max|logit|)")
    results["moonshot_g64_fixed"] = {
        "launches": launches, "prefill_ms": res_k["prefill_ms"],
        "tok_per_s": res_k["tok_per_s"], "decode_step_ms": res_k["decode_step_ms"],
        "plain_tok_per_s": res_p["tok_per_s"], "tokens_identical": same,
        "logits_rel_diff": rel}
    del qparams, res_k, res_p
    gc.collect()
    torch.cuda.empty_cache()

    # 13: tensor-parallel serving, 2 ranks on this card through --tp's own
    # launcher: w2a8_bs against phase 5's single-rank run, then w2a8_bs_g64
    # against a single-rank run here
    print(f"[13 tp] started at {time.perf_counter() - t_start:.1f}s", flush=True)
    from repro_torch.configs import get_config
    cfg = get_config("qwen1.5-0.5b")
    tp = {}
    for plan in ("w2a8_bs", "w2a8_bs_g64"):
        argv = ["--arch", "qwen1.5-0.5b", "--paged", "--plan", plan, "--device",
                "cuda"]
        args = serve.build_parser().parse_args(argv + ["--tp", "2"])
        if plan == "w2a8_bs":
            ref = tp1_bs
        else:
            cfg_1, qparams = serve.prepare(args)
            cap = {}
            res_1 = run_engine(torch, serve, cfg_1, qparams, args, cap)
            ref = {"tokens": [r.out for r in res_1["requests"]],
                   "first_logits": cap["first_logits"].cpu(),
                   "packed_bytes": {p: qw.packed.numel() * qw.packed.element_size()
                                    for p, qw in lm.qweights(qparams).items()},
                   "weight_bytes": res_1["weight_bytes"]}
            del qparams, res_1, cap
            gc.collect()
            torch.cuda.empty_cache()
        backend = mesh.backend_for(2, dev)
        t0 = time.perf_counter()
        res = mesh.run_ranks(serve.serve_rank, 2, args, ("lut_gemm_bitsliced",),
                             device="cuda")
        wall_s = time.perf_counter() - t0
        n = cfg.n_layers
        forwards = res["decode_steps"] + res["prefill_chunks"]
        for r, rk in enumerate(res["ranks"]):
            expect_launches(f"tp {plan} rank {r}", rk["launches"],
                            {"lut_gemm_bitsliced": 2 * n * forwards,
                             "lut_gemm_bs_fused": 5 * n * forwards,
                             "paged_attention": n * res["decode_steps"]})
        errs = [rk["first_step_errs"]["lut_gemm_bitsliced"] for rk in res["ranks"]]
        calls = [rk["first_step_calls"]["lut_gemm_bitsliced"] for rk in res["ranks"]]
        toks = res["tokens"]
        same = sum(a == b for a, b in zip(toks, ref["tokens"]))
        first = torch.from_numpy(res["first_logits"])
        rel = rel_diff(first, ref["first_logits"])
        identical = torch.equal(first, ref["first_logits"])
        half = [sum(rk["role_packed_bytes"].values()) for rk in res["ranks"]]
        whole = sum(ref["packed_bytes"][p] for p in res["ranks"][0]["role_packed_bytes"])
        exact_half = all(2 * b == ref["packed_bytes"][p] for rk in res["ranks"]
                         for p, b in rk["role_packed_bytes"].items())
        n_roles = len(res["ranks"][0]["role_packed_bytes"])
        print(f"[13 tp] {cfg.name} {plan}, --tp 2 on one card: backend {backend} "
              f"({res['backend']} in the ranks, on {res['device']}); the column "
              f"gather ran as a gloo all_gather on CUDA tensors: "
              f"{res['backend'] == 'gloo' and res['device'].startswith('cuda')}; "
              f"{len(toks)} requests, {sum(map(len, toks))} tokens, "
              f"{res['tok_per_s']:.1f} tok/s, decode-only step "
              f"{res['decode_step_ms']:.3f} ms on {smi}; {wall_s:.1f}s wall with "
              f"the ranks' start | launches per rank {[rk['launches'] for rk in res['ranks']]} "
              f"over {forwards} forwards, {res['decode_steps']} decode steps",
              flush=True)
        print(f"[13 tp] {plan}: ranks agree on tokens and first-step logits: "
              f"{res['ranks_agree']}; tokens identical to the single-rank run for "
              f"{same}/{len(toks)} requests; first decode step logits identical "
              f"{identical} (max rel diff {rel:.3g}); the first step's {calls} "
              f"lut_gemm_bitsliced calls per rank within {errs} of their plain "
              f"version (relative to max|plain|); packed bytes of the {n_roles} "
              f"role-stamped leaves per rank {half} of {whole} at tp=1 (each "
              f"exactly half: {exact_half}); parameter bytes per rank "
              f"{[rk['weight_bytes'] for rk in res['ranks']]}, "
              f"{ref['weight_bytes']} at tp=1", flush=True)
        if not res["ranks_agree"]:
            fail(f"tp {plan}: the ranks disagree on tokens or first-step logits")
        if calls != [2 * n] * 2:
            fail(f"tp {plan}: checked {calls} first-step lut_gemm_bitsliced calls, "
                 f"want {2 * n} per rank")
        if plan == "w2a8_bs":
            if max(errs) != 0.0:
                fail(f"tp {plan}: a first-step lut_gemm_bitsliced call differs "
                     f"from its plain version by {max(errs)}")
            if same != len(toks) or not identical:
                fail(f"tp {plan}: tokens identical for {same}/{len(toks)} "
                     f"requests, first-step logits identical {identical} (rel "
                     f"{rel}) against phase 5's single-rank run")
            if n_roles != 7 * n or not exact_half:
                fail(f"tp {plan}: {n_roles} role-stamped leaves (want {7 * n}), "
                     f"per-rank packed bytes exactly half: {exact_half}")
        else:
            if max(errs) > TOL_BS_GROUPED:
                fail(f"tp {plan}: a first-step lut_gemm_bitsliced call differs "
                     f"from its plain version by {max(errs)} > {TOL_BS_GROUPED}")
            if rel > TOL_LOGITS:
                fail(f"tp {plan}: first-step logits differ from the single-rank "
                     f"run by {rel} > {TOL_LOGITS}")
        tp[plan] = {"launches": [rk["launches"] for rk in res["ranks"]],
                    "backend": res["backend"], "tok_per_s": res["tok_per_s"],
                    "decode_step_ms": res["decode_step_ms"], "wall_s": wall_s,
                    "tokens_identical": same, "logits_identical": identical,
                    "logits_rel_diff": rel, "first_step_call_max_rel_err": max(errs),
                    "role_packed_bytes_per_rank": half, "role_packed_bytes_tp1": whole,
                    "weight_bytes_per_rank": [rk["weight_bytes"] for rk in res["ranks"]],
                    "weight_bytes_tp1": ref["weight_bytes"]}
    results["tp"] = tp

    print("[results] " + json.dumps({"engine": results}), flush=True)
    lc_split = long_ctx[LC_CONTEXTS[-1]]["split_launches"]
    sources = {"lut_gemm": ("src/repro_torch/csrc/lut_gemm.cu",
                            "src/repro/kernels/lut_gemm.py:152",
                            results["w2a2"]["launches"]["lut_gemm"], "w2a2"),
               "dequant_matmul": ("src/repro_torch/csrc/dequant_matmul.cu",
                                  "src/repro/kernels/lut_dequant_matmul.py:77",
                                  results["w2a16"]["launches"]["dequant_matmul"],
                                  "w2a16"),
               "lut_gemm_bs_fused": ("src/repro_torch/csrc/lut_gemm_bs_fused.cu",
                                     "src/repro/kernels/lut_gemm_bitsliced.py:292",
                                     results["w2a8_bs"]["launches"]["lut_gemm_bs_fused"],
                                     "w2a8_bs bf16"),
               "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:74",
                                   results["w2a2"]["launches"]["paged_attention"],
                                   None),
               "paged_attention_splitkv": ("src/repro_torch/csrc/paged_attention.cu",
                                           "src/repro/kernels/paged_attention.py:210",
                                           lc_split["paged_attention_splitkv"], None),
               "expert_dequant_matmul": (
                   "src/repro_torch/csrc/expert_gemm.cu",
                   "src/repro/kernels/expert_dequant_matmul.py:75",
                   moe["w2a16"]["launches"]["expert_dequant_matmul"], "w2a16"),
               "expert_lut_gemm": ("src/repro_torch/csrc/expert_gemm.cu",
                                   "src/repro/kernels/expert_dequant_matmul.py:167",
                                   moe["w2a2"]["launches"]["expert_lut_gemm"], "w2a2"),
               "lut_gemm_bitsliced": ("src/repro_torch/csrc/lut_gemm_bitsliced.cu",
                                      "src/repro/kernels/lut_gemm_bitsliced.py:155",
                                      tp["w2a8_bs"]["launches"][0]["lut_gemm_bitsliced"],
                                      "w2"),
               "kv_cache_attention": (
                   "src/repro_torch/csrc/kv_cache_attention.cu",
                   "src/repro/kernels/kv_cache_attention.py:81",
                   fixed["qwen1.5-0.5b w2a2"]["launches"]["kv_cache_attention"],
                   None)}
    kernels = []
    for name, (src, replaces, launches, cfg_name) in sources.items():
        if name in REPRESENTATIVE_ATTN:
            label, ks = REPRESENTATIVE_ATTN[name]
            rep = next(r for r in rows[name] if r["label"] == label
                       and r["kv_splits"] == ks)
        elif name == "kv_cache_attention":
            rep = next(r for r in rows[name] if r["label"] == "qwen serve")
        elif name.startswith("expert_"):
            rep = next(r for r in rows[name] if r["cfg"] == cfg_name
                       and (r["E"], r["M"], r["K"], r["N"]) == EXPERT_REPRESENTATIVE)
        else:
            rep = next(r for r in rows[name] if r["cfg"] == cfg_name
                       and (r["M"], r["K"], r["N"]) == REPRESENTATIVE)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"]})
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
