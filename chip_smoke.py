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
              2816x1024; M = 1, 4, 32, for lut_gemm and dequant_matmul
              also the fixed loop's prefill, M 128, and for w2a2 lut_gemm
              and w2a8_bs lut_gemm_bs_fused phase 14's M 8, 20 and 64: the
              verify at spec-k 1 and 4, two-row batched prefill; each
              lut_gemm and dequant_matmul line printing its tiling,
              kernels/lut_gemm.py::dense_partition: MT
              rows, NT columns, C cluster ranks, the rounds, its blocks and
              cudaOccupancyMaxActiveClusters) and, for lut_gemm_bs_fused, of
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
              at 8k and 32k context (block 512), one sequence at 32k with
              kv_splits 1, 16 and 32 (two clusters a head and the merge
              pass), with G = 8 (hd 128 at kv_splits 16: the largest block
              in the largest cluster) and at the edges
              (length 1, lengths off the block size, null-padded tables,
              kv_splits above the table width, chunks past every length,
              and a ragged 5008-row table whose single pass runs on 10
              cluster ranks, 8 of them past one sequence's length); each
              split line prints its clusters a head and ranks a cluster
              (kernels/paged_attention.py::split_clusters), its blocks and
              cudaOccupancyMaxActiveClusters,
              the library time being scaled_dot_product_attention over the
              pre-dequantized bf16 view; and the two expert GEMMs at
              moonshot-v1-16b-a3b's decode shapes (E 64, M 4, K x N =
              2048x1408 and 1408x2048; w2 per channel and g64, w4 for the
              dequant kernel), at M 16, at the decode shape with 24 of the
              64 experts flagged active as a decode step's dispatch leaves
              them (the bound counts the active experts' bytes), and at the
              edges (E 1, N off the column tile, K off the window, groups
              of 8 and one group per row, zero rows of unfilled capacity
              slots), each line with its tiling
              (kernels/lut_gemm.py::expert_partition), the library time
              being torch.bmm of the bf16 activations against the
              pre-dequantized bf16 weights; and
              kv_cache_attention over a dense slot cache at the fixed
              loop's serve shapes (qwen int8 and codeqwen int4, S 48), a
              GQA shape with S 1000, 8k / 32k context and a ragged S 5000
              (lengths 4999 and 700), the library time being
              scaled_dot_product_attention over the pre-dequantized bf16
              view. Each single-pass attention line prints its cluster
              size C (kernels/paged_attention.py::cluster_ranks), its
              blocks and cudaOccupancyMaxActiveClusters. Then the local
              slice's shapes: lut_gemm (w2a2) and lut_gemm_bs_fused
              (w2a8_bs) at gemma3-12b's projections (3840x4096, 3840x2048,
              4096x3840, 3840x15360, 15360x3840) and dequant_matmul (w2a16)
              at h2o-danube-3-4b's (3840x3840, 3840x960, 3840x10240,
              10240x3840), M 1, 4, 32, 128, each bit-identical to its
              plain version; the paged pair at gemma3's head (KV 8, G 2,
              hd 256) and danube's (KV 8, G 4, hd 120), int8, B 2 and 4,
              lengths 48, 1100, 8k and 32k, with no window and windows
              1024 and 4096 (the split at 8k with kv_splits 8, at 32k with
              24), and at the window's edges (its start on a block
              boundary and off it, a window shorter than a block and than
              a tile, lengths within the window, split chunks wholly below
              it, ranks past a length), each line with its kernel, plain,
              SDPA over the window's rows and bound (the window's bytes)
              times, after the clusters of C hd-256 blocks the card holds
              at once, C 1-8, against the table `cluster_ranks` reads
              (kernels/paged_attention.py::WIDE_RESIDENT);
              kv_cache_attention at both heads over a wrapped ring (W
              1024, and 4096 for danube) and a filling one, bit for bit.
              Then the recurrent slice's shapes: lut_gemm (w2a2) and
              lut_gemm_bs_fused (w2a8_bs) at recurrentgemma-9b's
              projections (4096x4096, 4096x256, 4096x12288, 12288x4096),
              dequant_matmul (w2a16) and lut_gemm (w2a2) at rwkv6-1.6b's
              (2048x2048, 2048x7168, 7168x2048), M 1, 4, 32, each
              bit-identical to its plain version; paged_attention at
              recurrentgemma's head (KV 1, G 16, hd 256; one launch a
              layer), window 2048, B 4, 8k and 32k of context, with SDPA
              over the window's rows and the window's byte bound; and
              kv_cache_attention at that head over its ring of 2048 rows,
              full and filling, bit for bit
  5 engine    qwen1.5-0.5b at full width with seeded random weights, packed
              under w2a2, w2a16 and w2a8_bs in turn, serving 12 requests
              through the paged engine via repro_torch.launch.serve; launch
              counts set to 0 just before each run and read just after: the
              plan's kernel launches 7 x 24 times per forward, the others 0;
              paged_attention 24 times per decode step, the split kernel 0
  6 plain     the runs with the registry's GEMMs forced onto the plain
              versions on the card (attention stays on its kernel), cut to
              the first 4 requests and 8 tokens since PR 25 and held
              against a kernel run of the same cut: under w2a2 and
              w2a8_bs, whose kernels are bit-identical to their plain
              versions, greedy tokens and first-decode-step logits must be
              identical; w2a16 first-decode-step logits within the stated
              tolerance. Then the 12 requests with the GEMM kernels on
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
              step times and a profile of each, the kv_splits 8 profile
              with no merge_kernel (8 chunks merge on chip); and, not as a
              gate, how far the plain single pass and the plain split move
              the logits
  9 codeqwen  codeqwen1.5-7b at full width (32 layers, untied head, int4
              pool) under w2a8_bs serving the 12 requests, with the
              attention-plain comparison and a profile, after the qwen
              engines are freed
  10 moe      moonshot-v1-16b-a3b at full width, cut to its first 4 of 48
              layers (64 experts, top-6, two shared experts, untied head,
              int8 pool; phase 12 keeps its full depth), drawn and packed
              layer by layer, serving the 12 requests under w2a2
              (expert_lut_gemm + lut_gemm) and w2a16 (expert_dequant_matmul +
              dequant_matmul), after the codeqwen engine is freed: launch
              counts exact (the expert op 3 x 4 per forward, the dense op
              7 x 4, paged_attention 4 per decode step, the others 0); a
              re-run with the expert and dense GEMMs on their plain versions
              (w2a2: tokens and first-step logits identical; w2a16: logits
              within the stated tolerance); a profile; peak device memory
  11 fixed    the fixed-batch loop (serve.py without --paged: 4 prompts of
              32 tokens, 16 generated) at full width, cut to the first 8
              layers (FIXED_LAYERS, since the local models' phases came;
              phases 15 and 16 run the loop at full depth):
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
  12 moe g64  moonshot-v1-16b-a3b at full width, cut to its first 12 of 48
              layers (MOE_FIXED_LAYERS, since the local models' phases
              came), under the grouped w2a2g64 plan through the fixed-batch
              loop: expert_lut_gemm launches exactly 3 x 12 x 16 times; a
              plain-GEMM re-run gives
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
              single-rank g64 run, both cut to the first TP_G64_CUT requests
              of TP_G64_GEN tokens: first-step calls within the grouped
              tolerance, first-step logits within the stated tolerance.
              Prints the backend, the decode-only step, tok/s and the bytes
              per rank: two ranks sharing one card through gloo measure
              correctness, not tensor-parallel speed
  14 features the paged engine's serving features, qwen1.5-0.5b at full
              width cut to its first 2 of 24 layers (FEAT_LAYERS, since
              the local models' phases came; its spec runs took 300 of
              its 417 s at 24 layers) under w2a8_bs (int8 pool): phase 5's 12
              requests, each prompt a shared 48-token prefix (3 blocks of
              16) before its own 4-32 tokens, 4 slots, 16 generated; the
              baseline is the chunked greedy engine. --prefix-cache and
              --prefill-batch 2 give the baseline's tokens, the cache
              sharing prompt tokens and computed prompt tokens falling by
              exactly as many; spec mode (spec-k 4) with a w2a2 drafter of
              the same weights, and with the target drafting for itself
              (which must emit more than one token a slot-step), leaves
              the baseline's greedy tokens only at near ties (top-2 margin
              below 2 x TOL_LOGITS of max|logit|), its logits on shared
              contexts within TOL_SHARED_LOGITS (printed: every divergence
              with its margin, acceptance, tokens a round, drafter
              evictions). --prefill whole leaves the baseline only at near
              ties too, its first-step logits within TOL_SHARED_LOGITS (it
              attends the prompt's unquantized K/V where chunked prefill
              attends the int8 pool's, so only the first step's are
              compared); its plain-GEMM re-run gives identical tokens.
              Seeded sampling (temperature 0.8, top-k 50, top-p 0.9, seed
              0) under w2a8_bs: a second run, a --prefill-batch 2 run and a
              plain-GEMM run give identical tokens, and top-k 1 gives the
              baseline's tokens; under spec mode at spec-k 1 (two drafter
              forwards a round, where spec-k 4 takes five): a second run,
              with --prefill-batch 2, and a plain-GEMM run give identical
              tokens, and top-k 1 leaves the baseline's tokens only at near
              ties. Launch
              counts exact in every kernel run (lut_gemm 7 x 2 per drafter
              forward, lut_gemm_bs_fused 7 x 2 per target forward,
              verify included, paged_attention 2 per one-token forward of
              either tree, the others 0); each run prints its decode-only
              step and tok/s beside the card's name and power limit. The
              baseline again with the request tracer attached
              (obs/trace.py): tokens and launch counts identical to the
              untraced run; its Chrome trace, written to a temporary
              directory, rendered by python -m repro_torch.analysis.report
              trace; TTFT and TPOT at p50 and p99 printed
  15 gemma3   gemma3-12b at full width and depth (48 layers: 40 local of
              window 1024, 8 global; hd 256, GeGLU, vocab 262144, tied
              head; int8 pool) under w2a8_bs, then w2a2: phase 5's 12
              requests through the paged engine (launches exact: the
              plan's GEMM 7 x 48 per forward, paged_attention 48 per decode
              step under kv_splits auto, the others 0); a plain-GEMM
              re-run cut to the first 4 requests and 8 tokens at full
              depth, against a kernel run of the same cut (tokens and
              first-step logits identical); a profile (under w2a8_bs) and
              the peak device memory. Under w2a8_bs also: 4 prompts of 1040-1100
              tokens (past the window; 384-row prefill chunks), 16
              generated, every attention call of the first decode step
              within TOL_ATTN of its plain version, and an attention-plain
              re-run of it (first-step logits within TOL_SHARED_LOGITS,
              beside what two plain formulations move them by); a planted
              decode at 8192 rows with kv_splits 8 and 1 on byte-identical
              state (every attention call of the first step within
              TOL_ATTN; the split's, the single pass's and the plain
              split's first-step logits within TOL_SHARED_LOGITS, beside
              the plain single pass against the plain split); the fixed
              loop with 2 prompts of 1536 tokens (every local ring wraps),
              every kv_cache_attention call of the first decode step
              identical to its plain version. Ring-paged local layers
              (--ring): the engine built at 4 slots and max_len 8192 and
              32768, with and without the ring, one at a time, printing
              the local layers' pool bytes and the device's peak (the
              ring's bytes the same at both lengths and n_ring_blocks x 16
              x the row's bytes); the planted 8192-row decode on a ring
              engine whose rings hold the last ring_len blocks of each
              slot, 4 steps against the engine without a ring (logits
              bitwise equal at every step, tokens identical, launches
              exact, the ring's first-step calls within TOL_ATTN); the
              window-crossing prompts through Engine(ring=True) (its chunks
              attend over the ring in the key chunks of the path without
              it: tokens identical and the logits of every step bitwise
              equal to the run without a ring, the count of differing
              tokens printed; launches exact)
  16 danube   h2o-danube-3-4b at full width and depth (24 layers, all local
              of window 4096, hd 120, untied head, int8 pool) under w2a16
              the same way: the 12 requests with exact launches, the
              plain-GEMM re-run, the window-crossing prompts with their
              attention-plain re-run, a planted decode at 8192 rows (past
              its window), the ring's memory and planted decode, and the
              fixed loop with one prompt of 4608 tokens
  17 cnn      the paper's deepgemm-cnn at full width (the stem and 8 stage
              convs, 3x3, widths 64-512; batch 8 of 32x32x3, M 8192 a
              conv) under w2a2, w4a4 and k-means w2a2 through
              models/cnn.py: each conv's lut_gemm call (its operands
              taken from the registry as conv2d_serve runs) against its
              plain version, exactly (a k-means float table's plain
              version replays the walk's order), and a k-means call also
              against the order-free ref_lut_gemm within TOL_LUT_FLOAT of
              max|plain|; its tiling, its time beside the plain
              version's, torch.matmul of the bf16 patches against the
              bf16 dequantized filters, F.conv2d (f32, no TF32) and the
              bound; then one forward with exactly 9 launches, the
              plain-backend stack bit for bit, the feature cosine to the
              fp32 stack above 0.3, and the forward's time (CUDA events
              over CNN_FORWARD_REPS forwards)
  18 quant    the quantization front end on qwen1.5-0.5b at full width, cut
              to its first QF_LAYERS of 24 layers, through the paged
              engine's 12 requests (exact launches): --nonuniform under
              w2a2 (row 1 on a float table) and w2a16 (row 2 on a float
              codebook), each with its tied plain-GEMM re-run of the first
              4 requests bit for bit, and with rows 1-2 at M 4 and 128 on
              the served w_up leaf (exact against the tied plain version;
              row 1 also within TOL_LUT_FLOAT of the order-free
              ref_lut_gemm); --plan w2a2
              --a-scale static (the calibration's seconds, a_sc on every
              lut_gemm leaf, the plain re-run bit for bit); --plan w2a8_bs
              --a-scale static (no a_sc, the dynamic run's bits); --plan
              legacy (no launch of rows 1-4)
  19 rgemma   recurrentgemma-9b at full width and depth (38 layers: 12 x
              (RG-LRU, RG-LRU, local MQA of window 2048) + 2 RG-LRU; 16
              query heads over one KV head of hd 256, so rows 5 and 9 run
              at G 16; GeGLU d_ff 12288, vocab 256000 tied, int8 pool)
              under w2a2, then w2a8_bs: phase 5's 12 requests through the
              paged engine (launches exact: the plan's GEMM 26 x 6 + 12 x
              7 = 240 per forward, paged_attention 12 per decode step, the
              others 0; every attention call of the first decode step
              within TOL_ATTN of its plain version); re-runs cut to the
              first 4 requests and 8 tokens with the GEMMs on their plain
              versions (tokens and first-step logits identical) and with
              attention on its plain version (logits within TOL_LOGITS);
              under w2a2 a profile splitting a step's device time into the
              dense GEMM kernels, the attention kernels and the rest (the
              RG-LRU's ATen ops among them); the peak device memory. Under
              w2a2 the
              fixed loop with 2 prompts of 2560 tokens (the local rings of
              2048 rows wrap; the RG-LRU states carried across the
              prefill), 16 generated, launches exact (kv_cache_attention
              12 x 15), the first step's kv_cache_attention calls identical
              to their plain version; the same prompts' prefill once more
              with the first lut_gemm call at each of the model's four
              (K, N) (M 5120, the long prefill's tiling) identical to its
              plain version; then a kernel run, a plain-GEMM run
              and an attention-plain run at 2 x RECURRENT_PLAIN_P (32)
              tokens and 8 generated, identical tokens and first-step
              logits
  20 rwkv6    rwkv6-1.6b at full width and depth (24 RWKV6 layers of 32
              heads of 64, d_ff 7168, vocab 65536 untied, layernorm, no
              attention) under w2a16, then w2a2, the same way: launches
              exact (the GEMM 24 x 8 = 192 per forward, no attention
              launch), the plain-GEMM re-run of the cut identical, the
              profile under w2a16; the engine's 32-row prefill chunks take
              wkv_scan, the fixed
              loop's 4 prompts of 128 tokens (w2a16) wkv_chunked, their
              prefill's first dequant_matmul call at each (K, N) identical
              to its plain version (M 512); the
              engine's peak device memory at max_len 2048 and 16384
              (equal: no pool, an O(1) state)
Each phase prints when it starts, and the run prints every phase's seconds
at its end.

Any failure exits nonzero. The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}. Without a CUDA
card, or without the repository's src/repro_torch beside this file, it
exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import os
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

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
# round in the order their plain versions repeat (ref.py::tile_order_matmul
# on dense_partition's and expert_partition's tilings), so they must be
# bit-identical. lut_gemm_bs_fused quantizes
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
# each 8 units' partial sum where the plain version scales each group's
TOL_EXPERT_GROUPED = 1e-5   # relative to max|plain|

SHAPES = ((1024, 1024), (1024, 2816), (2816, 1024))   # (K, N) per projection
ROWS = (1, 4, 32)                                      # decode / prefill chunk
DENSE_EXTRA_ROWS = (128,)    # lut_gemm / dequant_matmul: the fixed loop's prefill
# phase 14's M, off every tile: the verify's 4 slots x (spec-k + 1) at spec-k
# 1 and 4, and --prefill-batch 2 x the 32-row chunk; checked for lut_gemm
# under w2a2 (the drafter) and lut_gemm_bs_fused under w2a8_bs (the target)
FEATURE_ROWS = (8, 20, 64)
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
# phase 10 serves moonshot through the engine at this depth (full width):
# its plain-GEMM re-runs at 48 layers took most of the script's time, which
# phase 14 needs; phase 12 runs moonshot at full depth
MOE_ENGINE_LAYERS = 4
# experts a decode call of moonshot's fills: 4 slots x top-6 assignments
# reach at most 24 of the 64 experts
EXPERT_ACTIVE = 24
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
# the local-attention slice: row 9 at gemma3-12b's head (KV 8, G 2, hd 256)
# and h2o-danube-3-4b's (KV 8, G 4, hd 120) over a local layer's ring of W
# rows, its lengths min(pos + 1, W): full (wrapped) and filling
KV_CACHE_ROWS += (
    ("gemma3 ring W 1024", 4, 8, 2, 256, 8, 1024, (1024, 1024, 1024, 1024), "bf16"),
    ("gemma3 ring W 1024, filling", 4, 8, 2, 256, 8, 1024, (1024, 600, 1024, 17),
     "bf16"),
    ("gemma3 global 8k", 2, 8, 2, 256, 8, 8208, (8193, 8193), "bf16"),
    ("danube ring W 1024", 4, 8, 4, 120, 8, 1024, (1024, 1024, 1024, 1024), "bf16"),
    ("danube ring W 4096", 2, 8, 4, 120, 8, 4096, (4096, 4096), "bf16"),
    # the recurrent slice: row 9 at recurrentgemma-9b's head (KV 1, G 16, hd
    # 256) over its local layers' ring of 2048 rows, full (any context from
    # 2048 on: 8k, 32k) and filling
    ("rgemma ring W 2048", 4, 1, 16, 256, 8, 2048, (2048, 2048, 2048, 2048), "bf16"),
    ("rgemma ring W 2048, filling", 4, 1, 16, 256, 8, 2048, (2048, 1100, 2048, 9),
     "bf16"),
)
# rows 1-3 at the local models' projection shapes (K, N): gemma3-12b's (wq,
# wk/wv, wo, w_gate/w_up, w_down) under w2a2 (lut_gemm) and w2a8_bs
# (lut_gemm_bs_fused), h2o-danube-3-4b's (wq/wo, wk/wv, w_gate/w_up,
# w_down) under w2a16 (dequant_matmul)
GEMMA3_SHAPES = ((3840, 4096), (3840, 2048), (4096, 3840), (3840, 15360),
                 (15360, 3840))
DANUBE_SHAPES = ((3840, 3840), (3840, 960), (3840, 10240), (10240, 3840))
LOCAL_ROWS = (1, 4, 32, 128)
LOCAL_GEMM_RUNS = (("gemma3", GEMMA3_SHAPES, ("lut_gemm", "lut_gemm_bs_fused")),
                   ("danube", DANUBE_SHAPES, ("dequant_matmul",)))
# the recurrent slice: rows 1-3 at recurrentgemma-9b's projections (w_rnn_*
# and wq/wo 4096x4096, wk/wv 4096x256, w_gate/w_up 4096x12288, w_down
# 12288x4096) under w2a2 and w2a8_bs, and rwkv6-1.6b's (the time mix
# 2048x2048, wc_k 2048x7168, wc_v 7168x2048) under w2a16 and w2a2, at the
# engine's decode and chunk rows
RECURRENT_GEMM_RUNS = (
    ("rgemma", ((4096, 4096), (4096, 256), (4096, 12288), (12288, 4096)),
     ("lut_gemm", "lut_gemm_bs_fused")),
    ("rwkv6", ((2048, 2048), (2048, 7168), (7168, 2048)),
     ("dequant_matmul", "lut_gemm")))
RECURRENT_ROWS = (1, 4, 32)
# rows 5 and 6 at those heads, int8: B 2 and 4 at every length, with no
# window and windows 1024 and 4096 (the single pass; the split at 8k with
# kv_splits 8 and at 32k with 24, what --kv-splits auto gives gemma3's
# global layers there), then the window's edges
LOCAL_HEADS = {"gemma3": (8, 2, 256), "danube": (8, 4, 120)}
LOCAL_LENGTHS = (48, 1100, 8192, 32768)
LOCAL_WINDOWS = (None, 1024, 4096)
LOCAL_SPLITS = {8192: 8, 32768: 24}
# (label, head, B, block size, lengths, window, kv_splits)
LOCAL_ATTN_EDGES = (
    ("lo on a block boundary", "gemma3", 2, 16, (1040, 2064), 1024, 1),
    ("lo on a block boundary", "gemma3", 2, 16, (1040, 2064), 1024, 3),
    ("lo off a block", "gemma3", 2, 16, (1100, 1037), 1024, 1),
    ("lo off a block", "gemma3", 2, 16, (1100, 1037), 1024, 5),
    ("window < block", "danube", 2, 512, (3000, 700), 100, 1),
    ("window < block", "danube", 2, 512, (3000, 700), 100, 4),
    ("window < tile", "danube", 2, 16, (500, 77), 50, 1),
    ("window < tile", "danube", 2, 16, (500, 77), 50, 7),
    ("len <= window", "gemma3", 2, 16, (1024, 600), 1024, 1),
    ("len <= window", "gemma3", 2, 16, (1024, 600), 1024, 2),
    ("chunks below lo", "gemma3", 2, 512, (32768, 20000), 1024, 24),
    ("ranks past a length", "danube", 2, 16, (5000, 90), 4096, 1),
)
# row 5 at recurrentgemma-9b's head (KV 1, G 16, hd 256; one launch a
# layer), window 2048, B 4 at 8k and 32k of context (the single pass only:
# --kv-splits is refused for a recurrent arch)
RG_HEAD = {"rgemma": (1, 16, 256)}
RG_CONTEXTS = (8192, 32768)
RG_WINDOW = 2048
# phases 19 and 20: the recurrent models at full width and depth: (tag,
# arch, the engine's plans, the fixed loop's plan, batch and prompt).
# recurrentgemma's fixed prompts pass the window (2048) and are a multiple
# of 512, so the RG-LRU state is carried across a long prefill; rwkv6's
# 128 rows are a multiple of 64, so its prefill takes wkv_chunked (the
# engine's 32-row chunks take wkv_scan)
RECURRENT_MODELS = (("19 rgemma", "recurrentgemma-9b", ("w2a2", "w2a8_bs"), "w2a2", 2, 2560),
                    ("20 rwkv6", "rwkv6-1.6b", ("w2a16", "w2a2"), "w2a16", 4, 128))
# the fixed loop's plain-GEMM pair (kernel and plain GEMMs on the same
# prompts, cut to PLAIN_CUT_GEN tokens) at this prompt length: the plain
# lut_gemm at recurrentgemma's 2 x 2560 prefill rows would take minutes
# (at 2 x 128 its prefill alone took 29.4 s on an NVIDIA H100 80GB HBM3,
# 700 W)
RECURRENT_PLAIN_P = 32
# rwkv6's engine at these max_len: no pool, so the same peak memory
RWKV_MEM_LENS = (2048, 16384)
# the GEMM launches of one forward, by layer type: a recurrent layer's
# w_rnn_in, w_rnn_gate, w_rnn_out and its MLP's three; an attention
# layer's four and three; an rwkv layer's five time-mix and three
# channel-mix projections
GEMMS_PER_LAYER = {"recurrent": 6, "local": 7, "global": 7, "rwkv": 8}
# phases 15 and 16: the local models at full width and depth, int8 pool;
# (arch, plans, the fixed loop's batch and prompt: past the window, its
# length a multiple of 512 so the cacheless prefill takes 512-row chunks)
LOCAL_MODELS = (("gemma3-12b", ("w2a8_bs", "w2a2"), 2, 1536),
                ("h2o-danube-3-4b", ("w2a16",), 1, 4608))
# the plain-GEMM re-runs of phases 6, 15 and 16 take the first 4 requests
# and 8 tokens, against a kernel run of the same cut
PLAIN_CUT_REQUESTS, PLAIN_CUT_GEN = 4, 8
# the window-crossing run: 4 prompts of 1040-1100 tokens, 16 generated, in
# an engine of max_len 1152 (16-row blocks) with 384-row prefill chunks
LOCAL_CROSS = (1040, 1100, 4, 16)
LOCAL_CROSS_MAX_LEN, LOCAL_CROSS_CHUNK = 1152, 384
LOCAL_CTX = 8192               # the planted decode, kv_splits 1 and LC_SPLITS
# phases 15 and 16, ring-paged local layers (--ring): the engine's pools at
# RING_SLOTS slots (16-row blocks, chunks of two) at each of RING_MAX_LENS,
# with and without the ring; the planted decode at LOCAL_CTX through both,
# RING_STEPS steps; phase 15 also serves the window-crossing prompts on it
RING_SLOTS = 4
RING_MAX_LENS = (8192, 32768)
RING_STEPS = 4
RING_CROSS_ARCH = "gemma3-12b"
# phase 14 serves qwen1.5-0.5b at this depth (full width): its spec runs
# took 300 of its 417 s at 24 layers, which phases 15 and 16 need
FEAT_LAYERS = 2
# phases 11 and 12 run the fixed loop at these depths (full width): 107.3
# and 51.4 s of the 1164.4 s of the first full run with phases 15 and 16,
# on a host 1.5x slower than PR 23's
FIXED_LAYERS = 8
MOE_FIXED_LAYERS = 12
# phase 13's w2a8_bs_g64 pair (single rank and --tp 2) serves the first
# TP_G64_CUT requests of TP_G64_GEN tokens: at 12 x 16 the pair took 70 s of
# the phase's 129.9 in a 960.4 s run (NVIDIA H100 80GB HBM3, 700 W, on a
# slow host), against a ~900 s aim
TP_G64_CUT, TP_G64_GEN = 4, 8
# the fixed-batch loop's runs: (arch, plan, the plan's dense GEMM op)
FIXED_RUNS = (("qwen1.5-0.5b", "w2a2", "lut_gemm"),
              ("qwen1.5-0.5b", "w2a16", "dequant_matmul"),
              ("qwen1.5-0.5b", "w2a8_bs", "lut_gemm_bs_fused"),
              ("codeqwen1.5-7b", "w2a8_bs", "lut_gemm_bs_fused"))


# phase 17: the paper's CNN (configs/deepgemm_cnn.py) at full width, the
# batch of benchmarks/end2end.py: 9 convs as im2col lut_gemm calls of M
# 8192; (label, w_bits, a_bits, k-means codebook)
CNN_BATCH = 8
CNN_PLANS = (("w2a2", 2, 2, False), ("w4a4", 4, 4, False), ("kmeans w2a2", 2, 2, True))
CNN_MIN_COSINE = 0.3          # examples/cnn_paper_repro.py's assertion
CNN_FORWARD_REPS = 5          # forwards timed between CUDA events (after 3 warm-ups)
# a float (k-means) table's lut_gemm call against the order-free
# ref_lut_gemm, of max|plain|: the sums round in another order (the tied
# plain version is the exact gate)
TOL_LUT_FLOAT = 1e-5
# phase 18: qwen1.5-0.5b at full width, cut to this depth, through the
# paged engine under the quantization front end's flags: (label, flags,
# the dense GEMM op); the k-means and static runs are held bit for bit
# against a plain-GEMM re-run of the first PLAIN_CUT_REQUESTS requests (a
# float product table sums in the walk's order in lut_gemm's plain
# version too: an untied one moved the first-step logits by 0.509 of
# max|logit| through the 2-bit activation codes, ROADMAP queue 3)
QF_LAYERS = 8
QF_RUNS = (("kmeans w2a2", ["--plan", "w2a2", "--nonuniform"], "lut_gemm"),
           ("kmeans w2a16", ["--nonuniform"], "dequant_matmul"),
           ("static w2a2", ["--plan", "w2a2", "--a-scale", "static",
                            "--calib-batches", "4"], "lut_gemm"),
           ("static w2a8_bs", ["--plan", "w2a8_bs", "--a-scale", "static"],
            "lut_gemm_bs_fused"),
           ("dynamic w2a8_bs", ["--plan", "w2a8_bs"], "lut_gemm_bs_fused"),
           ("legacy", ["--plan", "legacy"], None))
QF_KERNEL_ROWS = (4, 128)     # rows 1-2 on a k-means leaf of qwen's w_up


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


def loop_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls between CUDA events
    after three warm-up calls (for library calls kept out of a graph)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
        for M in ROWS + DENSE_EXTRA_ROWS + FEATURE_ROWS:
            feature = M in FEATURE_ROWS
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            # lut_gemm: w2a2, w2a2g64, w4a8 (phase 14's M: w2a2)
            for wb, ab, G in ((2, 2, None),) + (() if feature else
                                                ((2, 2, 64), (4, 8, None))):
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
                record("lut_gemm", cfg, M, K, N, err, ok, k_ms, p_ms, l_ms, b, by,
                       dense_tiling("lut_gemm", M, N, K, wb, ab, G))
            # dequant_matmul: w2, w2g128, w4 (bf16 activations, as served)
            for wb, G in () if feature else ((2, None), (2, 128), (4, None)):
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
                       b, by, dense_tiling("dequant_matmul", M, N, K, wb, 16, G))
            if M not in ROWS + FEATURE_ROWS:
                continue
            # lut_gemm_bs_fused: raw activations with an all-zero row (the
            # scale floor) and a row whose amax sits in one element
            xe = x.clone()
            if M >= 4:
                xe[0] = 0
                xe[1] *= 1e-3
                xe[1, K // 3] = 40.0
            cases = [(2, None, "bf16", None)] + ([] if feature else [
                (2, 64, "bf16", None), (4, None, "bf16", None)])
            if (K, N) == (1024, 2816) and not feature:
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


def dense_tiling(op, M, N, K, w_bits, a_bits, group):
    """The tiling of lut_gemm / dequant_matmul (bf16 activations: a_bits 16)
    at these shapes (kernels/lut_gemm.py::dense_partition): MT, NT, C, the
    window, the blocks and cudaOccupancyMaxActiveClusters."""
    from repro_torch.kernels.lut_gemm import dense_active_clusters, dense_rounds
    (MT, NT, C, kpr), active = dense_active_clusters(op, M, N, K, w_bits, a_bits, group)
    return {"MT": MT, "NT": NT, "cluster": C, "k_per_rank": kpr,
            "rounds": dense_rounds(K, C, kpr),
            "blocks": -(-N // NT) * -(-M // MT) * C, "active_clusters": active}


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
    ("N off the column tile", 8, 4, 2048, 1003, 2, None, False),
    ("K off the window", 8, 4, 1400, 512, 2, None, False),
    ("G 8, two groups per lane word", 4, 4, 2048, 256, 2, 8, False),
    ("one group per row", 4, 4, 2048, 256, 2, 2048, False),
    ("unfilled capacity slots", 64, 4, 2048, 1408, 2, None, True),
)


def expert_tiling(op, E, M, N, K, bits, a_bits, group):
    """The expert kernels' tiling at these shapes (expert_partition): MT,
    NT, C, the window, the blocks and the clusters (blocks at C 1) the card
    holds at once."""
    from repro_torch.kernels.expert_gemm import expert_active_clusters
    from repro_torch.kernels.lut_gemm import dense_rounds
    (MT, NT, C, kpr), active = expert_active_clusters(op, E, M, N, K, bits, a_bits, group)
    return {"MT": MT, "NT": NT, "cluster": C, "k_per_rank": kpr,
            "rounds": dense_rounds(K, C, kpr),
            "blocks": E * -(-N // NT) * -(-M // MT) * C, "active_clusters": active}


def phase_experts(torch, dev):
    """The two expert GEMMs against their plain versions: EXPERT_SHAPES at
    w2, w2 g64 and (dequant kernel) w4, the decode shape with EXPERT_ACTIVE
    of its experts flagged active (drawn from the seed; the others' rows
    zero, as the dispatch leaves them), then EXPERT_EDGES. Activations are
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
        cases += [("expert_dequant_matmul", label, E, M, K, N, b, G, False, None)
                  for b, G in ((2, None), (2, 64), (4, None))]
        cases += [("expert_lut_gemm", label, E, M, K, N, 2, G, False, None)
                  for G in (None, 64)]
    E, M, K, N = EXPERT_REPRESENTATIVE
    cases += [(name, f"moonshot decode, {EXPERT_ACTIVE} of {E} experts", E, M, K, N, 2,
               None, False, EXPERT_ACTIVE) for name in rows]
    cases += [(name, *edge, None) for edge in EXPERT_EDGES for name in rows]
    for name, label, E, M, K, N, bits, G, zero, n_active in cases:
        w_idx = torch.randint(0, 2 ** bits, (E, N, K), generator=gen, device=dev,
                              dtype=torch.uint8)
        wp = packing.pack(w_idx, bits)
        levels = quant.uniform_codebook(bits, device=dev).levels
        sc_shape = (E, N) if G is None else (E, N, K // G)
        on = torch.ones(E, dtype=torch.bool, device=dev)
        if n_active is not None:
            on[torch.randperm(E, generator=gen, device=dev)[n_active:]] = False
        if zero:
            on[::3] = False                           # rows of unfilled slots, unflagged
        flags = None if n_active is None else on
        if name == "expert_dequant_matmul":
            x = torch.randn((E, M, K), generator=gen, device=dev).to(torch.bfloat16)
            x[~on] = 0
            sc = torch.rand(sc_shape, generator=gen, device=dev) * 0.1 + 0.01
            ops, kw = (x, wp, levels, sc), dict(bits=bits, group_size=G, active=flags)
            w_scale = sc[..., None] if G is None else quant.expand_group_scales(sc, G)
            xb, n_in, peak = x, nbytes(x[on], levels, sc[on]), BF16_TC_FLOPS
            a_bits = 16
        else:
            a_idx = torch.randint(0, 2 ** bits, (E, M, K), generator=gen, device=dev,
                                  dtype=torch.uint8)
            a_idx[~on] = 2 ** (bits - 1)              # the code of 0.0
            ap = packing.pack(a_idx, bits)
            lut = product_lut(levels, levels).table
            sc = None if G is None else (
                torch.rand(sc_shape, generator=gen, device=dev) * 0.1 + 0.01)
            ops, kw = (ap, wp, lut, sc), dict(w_bits=bits, a_bits=bits,
                                             group_size=G, active=flags)
            w_scale = 1.0 if G is None else quant.expand_group_scales(sc, G)
            xb = levels[a_idx.long()].to(torch.bfloat16)
            n_in = nbytes(ap[on], lut, None if sc is None else sc[on])
            peak, a_bits = INT8_TC_OPS, bits
        kern, plain = getattr(EG, f"{name}_cuda"), getattr(EG, f"{name}_plain")
        got = kern(*ops, **kw)
        torch.cuda.synchronize()
        want = plain(*ops, **kw)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        exact = name == "expert_dequant_matmul" or G is None
        ok = bool(torch.isfinite(got).all()) and (
            err == 0.0 if exact else err <= TOL_EXPERT_GROUPED * scale)
        zero_ok = bool(on.all()) or got[~on].abs().max().item() == 0.0
        wdq = (levels[w_idx.long()] * w_scale).to(torch.bfloat16) \
            .transpose(1, 2).contiguous()                      # (E, K, N)
        del w_idx
        k_ms = graph_ms(torch, lambda: kern(*ops, **kw))
        p_ms = graph_ms(torch, lambda: plain(*ops, **kw), reps=2, replays=2)
        l_ms = graph_ms(torch, lambda: torch.bmm(xb, wdq))
        del wdq
        # the work the flags leave: the active experts' inputs and products
        n_on = int(on.sum().item()) if flags is not None else E
        w_bytes = nbytes(wp[on]) if flags is not None else nbytes(wp)
        if flags is None:
            n_in = nbytes(*ops[:1], *ops[2:])
        b, by = bound_ms(w_bytes + n_in + E * M * N * 4, 2 * n_on * M * N * K, peak)
        cfg = f"w{bits}" + ("a16" if name == "expert_dequant_matmul" else f"a{bits}") \
            + (f"g{G}" if G else "")
        tiling = expert_tiling(name, E, M, N, K, bits, a_bits, G)
        rows[name].append({
            "kernel": name, "label": label, "cfg": cfg, "E": E, "M": M, "K": K,
            "N": N, "active": n_on, "max_abs_err": err, "max_abs_plain": scale,
            "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b,
            "bound_by": by, **tiling})
        print(f"  {name:21s} {label:34s} {cfg:8s} E={E:<2d} M={M:<2d} K={K:<4d} "
              f"N={N:<4d} err={err:.3g} (max|plain| {scale:.3g}) kernel={k_ms:.5f}ms "
              f"plain={p_ms:.5f}ms bmm={l_ms:.5f}ms bound={b:.5f}ms ({by}); "
              f"{bs_tiling_text(tiling)}", flush=True)
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
    ("long 32k, one sequence", 1, 16, 1, 64, 8, 512, (32768,), 64, 1, "bf16"),
    ("long 32k, one sequence", 1, 16, 1, 64, 8, 512, (32768,), 64, 16, "bf16"),
    ("long 32k, one sequence", 1, 16, 1, 64, 8, 512, (32768,), 64, 32, "bf16"),
    ("long 32k", 2, 16, 1, 64, 8, 512, (32768, 32768), 68, 16, "bf16"),
    ("G=8", 2, 2, 8, 128, 8, 16, (100, 300), 20, 16, "f32"),
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
            K, C, active = PA.paged_attention_splitkv_active_clusters(
                B, KV, G, hd, bs, nb, bits, q_dtype, ks)
            row.update(clusters_per_head=K, cluster=C, blocks=B * KV * K * C,
                       active_clusters=active)
            grid = (f"{K} cluster(s) a head of {C} ranks, {B * KV * K * C} blocks"
                    f"{' + merge' if K > 1 else ''}, {active} clusters active at once")
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


def run_engine(torch, serve, cfg, qparams, args, capture: dict, requests=None,
               logits_by_step: dict | None = None, check_first: list | None = None,
               check_ops: tuple = None, **engine_kw):
    """One serve run through the CLI's code path (of ``requests``, else the
    CLI's own); checks every decode and verify forward's logits are finite
    and keeps the first decode step's. With ``logits_by_step``, the logits
    each emitted token was chosen from, by (uid, step): a decode step's
    row, or the verify row at the token's position (a later round
    overwrites a position a rejected draft had filled). With
    ``check_first``, every attention call (every call of ``check_ops``) of
    the first decode step is also run through its plain version and its
    error appended there."""
    from repro_torch.serving.engine import _DECODE

    engine = serve.make_engine(cfg, qparams, args, **engine_kw)
    inner_d, inner_v = engine._decode_fn, engine._verify_fn

    def record(logits):
        if not bool(torch.isfinite(logits).all()):
            fail(f"{cfg.name} {cfg.quant} produced non-finite logits")
        if logits_by_step is not None:
            rows = logits if logits.ndim == 3 else logits[:, None]
            for i, s in enumerate(engine.slots):
                if s.state == _DECODE:
                    for j in range(rows.shape[1]):
                        logits_by_step[(s.req.uid, len(s.req.out) + j)] = rows[i, j].clone()
        return logits

    def decode(*a):
        first = check_first is not None and "first_logits" not in capture
        with checked_attention_calls(check_first, check_ops or ATTN_OPS) if first \
                else contextlib.nullcontext():
            logits = record(inner_d(*a))
        capture.setdefault("first_logits", logits.clone())
        return logits

    engine._decode_fn = decode
    engine._verify_fn = lambda *a: record(inner_v(*a))
    res = serve.serve_paged(cfg, qparams, args, engine=engine, requests=requests)
    if not all(r.done for r in res["requests"]):
        fail("not every request finished")
    res["weight_bytes"] = res.pop("engine").per_device_weight_bytes()
    return res


def plain_gemms(c):
    """``c`` with its plan's GEMMs on their plain versions (backend "ref")."""
    return dataclasses.replace(c, quant=dataclasses.replace(c.quant, backend="ref"))


def reset_counts(wrappers: dict) -> None:
    for w in wrappers.values():
        w.launches = 0


def launch_counts(wrappers: dict) -> dict:
    return {name: w.launches for name, w in wrappers.items()}


def forwards(res: dict) -> int:
    """An engine run's forwards: its decode steps and prefill chunks."""
    return res["metrics"]["decode_steps"] + res["metrics"]["prefill_chunks"]


def counted_engine_run(torch, serve, wrappers: dict, qparams, head: str, smi: str,
                       label: str, c, run_args, requests=None, check_first=None,
                       **kw) -> dict:
    """One engine run (``run_engine``; ``check_first`` as there) with the
    launch counts of ``wrappers`` set to 0 just before and read just after,
    kept with its first decode step's logits; prints a line headed
    ``head``."""
    cap: dict = {}
    reset_counts(wrappers)
    r = run_engine(torch, serve, c, qparams, run_args, cap, requests=requests,
                   check_first=check_first, **kw)
    r["launches"] = launch_counts(wrappers)
    r["first_logits"] = cap["first_logits"]
    m = r["metrics"]
    print(f"{head} {label}: {len(r['requests'])} requests, {r['tokens']} tokens, "
          f"{r['tok_per_s']:.1f} tok/s, decode-only step {r['decode_step_ms']:.3f} ms "
          f"on {smi} | launches {r['launches']} over {forwards(r)} forwards, "
          f"{m['decode_steps']} decode steps | {r['seconds']:.1f}s", flush=True)
    return r


def profile_steps(torch, step, steps: int, label: str) -> dict:
    """torch.profiler over ``steps`` calls of ``step``: wall and device-busy
    time per step (the idle share), kernels per step, device ms per step by
    kernel name, the device ms of the kernels launched inside the recurrent
    blocks' ``record_function`` ranges (``recurrent.RECURRENCE_RANGES``),
    and the top host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.recurrent import RECURRENCE_RANGES

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # the device timeline's kernels and copies; a record_function range's
    # own span on it (a user annotation) is no device work
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name not in RECURRENCE_RANGES]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
    # a range's host event sums the kernels launched inside it (its ops'
    # and their children's)
    rec_ms = {r: sum(getattr(e, "device_time_total", 0.0) for e in prof.events()
                     if e.device_type == DeviceType.CPU and e.name == r) / 1e3 / steps
              for r in RECURRENCE_RANGES}
    by_dev: dict = {}
    for e in dev:
        by_dev[e.name] = by_dev.get(e.name, 0.0) + e.time_range.elapsed_us()
    top_dev = sorted(by_dev.items(), key=lambda kv: -kv[1])[:5]
    top_cpu = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:6]
    # kernel families by name: paged_attn_ is the paged single pass and the
    # split (paged_attn_cluster_kernel; paged_attn_split_kernel above one
    # cluster a head, followed by merge_kernel)
    fam_ms = {k: sum(us for n, us in by_dev.items() if k in n) / 1e3 / steps
              for k in ("paged_attn_", "merge_kernel", "kv_cache_attn_kernel",
                        "expert_dequant_kernel", "expert_lut_kernel")}
    attn_ms = {k: fam_ms[k] for k in ("paged_attn_", "merge_kernel",
                                      "kv_cache_attn_kernel")}
    expert_ms = fam_ms["expert_dequant_kernel"] + fam_ms["expert_lut_kernel"]
    # the dense GEMM kernels (rows 1-4), and everything that is none of the
    # port's kernels: ATen's elementwise, reduction and copy kernels (the
    # RG-LRU and WKV recurrences, norms, activation quantizers, the head)
    gemm_ms = sum(us for n, us in by_dev.items() if any(
        k in n for k in ("lut_gemm_kernel", "dequant_matmul_kernel", "bs_fused_kernel",
                         "bs_two_step_kernel"))) / 1e3 / steps
    other_ms = busy_ms - gemm_ms - sum(attn_ms.values()) - expert_ms
    out = {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "kernels_per_step": len(dev) / steps,
           "attention_device_ms_per_step": attn_ms,
           "expert_device_ms_per_step": expert_ms,
           "gemm_device_ms_per_step": gemm_ms,
           "other_device_ms_per_step": other_ms,
           "recurrence_device_ms_per_step": rec_ms,
           "top_device_ms_per_step": [(n[:60], us / 1e3 / steps) for n, us in top_dev],
           "top_host_self_ms_per_step": [(a.key[:60], a.self_cpu_time_total / 1e3 / steps)
                                         for a in top_cpu]}
    print(f"{label}, {steps} steps: wall {wall_ms:.2f} ms/step, device busy "
          f"{busy_ms:.2f} ms/step (idle share {out['idle_share']:.3f}), "
          f"{out['kernels_per_step']:.0f} kernels/step, attention kernels "
          f"{attn_ms['paged_attn_']:.3f} ms/step (+ merge "
          f"{attn_ms['merge_kernel']:.3f}; dense-cache "
          f"{attn_ms['kv_cache_attn_kernel']:.3f}), expert kernels "
          f"{expert_ms:.3f}, dense GEMM kernels {gemm_ms:.3f}, other (ATen) "
          f"{other_ms:.3f} ms/step, of which in the recurrences' ranges "
          f"{sum(rec_ms.values()):.3f}", flush=True)
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


def checked_attention_calls(errs: list, ops: tuple = ATTN_OPS):
    """While active, every call of ``ops`` (the attention ops) the registry
    sends to its kernel is also run through its plain version on the same
    inputs (no launch), and max|kernel - plain| / max|plain| of each call
    is appended to ``errs``."""
    from repro_torch.kernels import registry
    return registry.checked_against_plain(ops, errs)


def checked_first_calls(op: str, errs: dict):
    """While active, the first call the registry sends to ``op``'s kernel
    at each packed weight shape is also run through the op's plain version
    on the same inputs (no launch): errs[weight shape] = (M, max|kernel -
    plain| / max|plain|). The other calls run as before."""
    from repro_torch.kernels import registry

    def check(o, arrays, static, out):
        key = tuple(arrays[1].shape)
        if key not in errs:
            want = o.plain(*arrays, **static)
            den = want.abs().max().item()
            err = (out - want).abs().max().item()
            errs[key] = (arrays[0].shape[0], err / den if den else err)
    return registry.watched((op,), check)


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
                     gen_steps: int = LC_GEN, profile: bool = True,
                     label: str = "8 long") -> dict:
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
                         f"[{label}] ctx {ctx} kv_splits {kv_splits} profile") \
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


# phase 14: the paged engine's serving features, qwen1.5-0.5b at full width
FEAT_ARGS = ["--arch", "qwen1.5-0.5b", "--paged", "--plan", "w2a8_bs", "--device",
             "cuda"]
FEAT_PREFIX = 48               # shared prompt prefix: 3 blocks of 16
FEAT_SAMPLING = ["--temperature", "0.8", "--top-k", "50", "--top-p", "0.9",
                 "--seed", "0"]
# a greedy divergence between two float formulations is a near tie when the
# baseline's top-2 margin at that step is below what each may move a logit:
# TOL_LOGITS of max|logit| each, so twice that
NEAR_TIE_REL = 2 * TOL_LOGITS
# spec's verify (S = k+1, gathered plain attention) against plain decode
# (S = 1, the paged kernel) on the same contexts, over every step: on random
# quantized weights two formulations' last-ulp differences have moved
# logits by up to 0.14 of max|logit| (two plain attention passes at 32k;
# ROADMAP queue 3); a wrong context moves them by the order of max|logit|
TOL_SHARED_LOGITS = 0.15
# phases 15 and 16 hold the kernel-vs-plain first-step logits of the runs
# whose contexts pass the window (1040-1100 rows, and the planted 8192) to
# TOL_SHARED_LOGITS too: there every attention call meets its plain version
# within TOL_ATTN, and 48 quantized layers carry the last-ulp differences
# of two float formulations to the logits (gemma3-12b's read 0.0218 of
# max|logit| at 1040-1100 rows, where each of its 48 calls was within
# 3e-7); each such line prints how far two plain formulations (the single
# pass and the split) move the same logits
FEAT_SAMPLED_SPEC_K = 1        # the sampled spec runs: 2 drafter forwards a round


def near_ties(want: list, got: list, logits: dict, other: dict | None = None):
    """Where ``got``'s tokens leave ``want``'s: (uid, step, top-2 margin of
    want's logits there relative to their max|logit|) for every request that
    diverges, and, with ``other`` (got's logits by step), the largest
    relative difference of the two runs' logits over the steps of ``other``
    whose context is still shared (up to and including the first
    divergence)."""
    ties, worst = [], 0.0
    for uid, (w, g) in enumerate(zip(want, got)):
        d = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), len(w))
        if d < len(w):
            top = logits[(uid, d)].topk(2).values
            ties.append((uid, d, float((top[0] - top[1]) / logits[(uid, d)].abs().max())))
        if other is not None:
            for s in range(min(d + 1, len(w))):
                if (uid, s) in other:
                    worst = max(worst, rel_diff(other[(uid, s)], logits[(uid, s)]))
    return ties, worst


def phase_features(torch, serve, wrappers: dict, gemms: dict, smi: str,
                   expect_launches) -> dict:
    """Phase 14 (see the module docstring)."""
    from repro_torch.serving import Request

    parse = serve.build_parser().parse_args
    long_args = FEAT_ARGS + ["--prompt-len", str(FEAT_PREFIX + 32)]
    args = parse(long_args)
    cfg, desc = serve.config_for(args)
    cfg = dataclasses.replace(cfg, n_layers=FEAT_LAYERS)   # the first FEAT_LAYERS layers
    qparams = serve.pack_params(cfg, args, desc)
    dcfg, dparams = serve.prepare_drafter(parse(FEAT_ARGS + ["--spec-draft-plan", "w2a2"]),
                                          cfg)
    print(f"[14 features] {cfg.name} at full width, cut to its first {FEAT_LAYERS} "
          "of 24 layers (target and drafter)", flush=True)
    prefix = np.random.default_rng(args.seed + 1).integers(0, cfg.vocab_size, FEAT_PREFIX)
    prompts = [np.concatenate([prefix, r.prompt])
               for r in serve.make_requests(cfg, parse(FEAT_ARGS))]
    n = cfg.n_layers

    # a w2a2 drafter of the target's weights, or the target itself
    drafters = {"w2a2": (dcfg, dparams), "self": (cfg, qparams)}
    out: dict = {}

    def run(label, run_args, drafter=None, gemm_plain=False, logits=None, **kw):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        spec = None
        if drafter:
            dc, dp = drafters[drafter]
            spec = (plain_gemms(dc) if gemm_plain else dc, dp)
        reqs = [Request(uid=i, prompt=p, max_new=run_args.gen)
                for i, p in enumerate(prompts)]
        res = run_engine(torch, serve, plain_gemms(cfg) if gemm_plain else cfg, qparams,
                         run_args, {}, requests=reqs, logits_by_step=logits,
                         spec=spec, **kw)
        launches = {name: w.launches for name, w in wrappers.items()}
        m = res["metrics"]
        if gemm_plain:
            if any(gemms[g].launches for g in gemms):
                fail(f"features {label}: the plain-GEMM run launched a GEMM kernel")
        elif spec:
            sp, k = m["spec"], run_args.spec_k
            drafts = 7 * n * ((k + 1) * sp["rounds"] + sp["draft_prefill_chunks"])
            target = 7 * n * (m["prefill_chunks"] + sp["rounds"])
            expect_launches(f"features {label}", launches, {
                **({"lut_gemm": drafts, "lut_gemm_bs_fused": target}
                   if drafter == "w2a2" else {"lut_gemm_bs_fused": drafts + target}),
                "paged_attention": n * (k + 1) * sp["rounds"]})
        else:
            whole = len(prompts) if run_args.prefill == "whole" else 0
            if whole and m["preemptions"]:
                fail(f"features {label}: {m['preemptions']} preemptions in an ample pool")
            expect_launches(f"features {label}", launches, {
                "lut_gemm_bs_fused": 7 * n * (m["prefill_chunks"] + whole
                                              + m["decode_steps"]),
                "paged_attention": n * m["decode_steps"]})
        step = res["decode_step_ms"]
        line = (f"[14 features] {label}: {res['tokens']} tokens, {res['tok_per_s']:.1f} "
                f"tok/s, decode-only step {f'{step:.3f} ms' if step else 'none'} on "
                f"{smi} | decode steps {m['decode_steps']}, prefill chunks "
                f"{m['prefill_chunks']}, prefill tokens computed "
                f"{m['prefill_tokens_computed']} / shared {m['prefill_tokens_shared']}"
                f" | {time.perf_counter() - t0:.1f}s")
        if m["spec"] is not None:
            sp = m["spec"]
            line += (f" | spec: {sp['rounds']} rounds, {sp['emitted']} tokens "
                     f"({sp['emitted'] / max(sp['rounds'], 1):.2f} a round, "
                     f"{sp['accepted_tokens_per_step']:.3f} a slot-step), acceptance "
                     f"{sp['acceptance_rate']:.3f} of {sp['draft_tokens']} drafts, "
                     f"{sp['draft_evictions']} drafter evictions, "
                     f"{sp['draft_prefill_chunks']} drafter catch-up chunks")
        print(line, flush=True)
        out[label] = {"tok_per_s": res["tok_per_s"], "decode_step_ms": step,
                      "launches": launches, "seconds": time.perf_counter() - t0,
                      **{key: m[key] for key in ("decode_steps", "prefill_chunks",
                                                 "prefill_tokens_computed",
                                                 "prefill_tokens_shared", "spec")}}
        return [r.out for r in reqs], m

    def same(label, want, got):
        ok = sum(a == b for a, b in zip(want, got))
        print(f"[14 features] {label}: tokens identical for {ok}/{len(want)} "
              "requests", flush=True)
        if ok != len(want):
            fail(f"features {label}: tokens identical for {ok}/{len(want)} requests")

    def tie_gate(label, want, got, logits, other):
        ties, worst = near_ties(want, got, logits, other)
        print(f"[14 features] {label}: {len(ties)} of {len(want)} requests leave the "
              f"baseline's tokens, at (uid, step, top-2 margin / max|logit|) {ties}; "
              f"logits on shared contexts within {worst:.3g} of max|logit|", flush=True)
        bad = [t for t in ties if t[2] >= NEAR_TIE_REL]
        if bad or worst > TOL_SHARED_LOGITS:
            fail(f"features {label}: divergences past a near tie ({NEAR_TIE_REL} of "
                 f"max|logit|) {bad}, or logits on shared contexts {worst} > "
                 f"{TOL_SHARED_LOGITS}")
        out[label] = {"near_ties": ties, "shared_context_logits_rel_diff": worst}

    base_logits: dict = {}
    baseline, m0 = run("baseline (chunked, greedy)", args, logits=base_logits)
    out["tracer"] = phase_tracer(torch, run, same, args, baseline, out, smi)
    pc, m1 = run("--prefix-cache", parse(long_args + ["--prefix-cache"]))
    same("--prefix-cache against the baseline", baseline, pc)
    drop = m0["prefill_tokens_computed"] - m1["prefill_tokens_computed"]
    print(f"[14 features] --prefix-cache: prefill tokens shared "
          f"{m1['prefill_tokens_shared']}, computed fell by {drop}; radix "
          f"{m1['prefix_cache']}", flush=True)
    if not 0 < m1["prefill_tokens_shared"] == drop:
        fail(f"features --prefix-cache: shared {m1['prefill_tokens_shared']}, "
             f"computed fell by {drop}")
    pb, _ = run("--prefill-batch 2", parse(long_args + ["--prefill-batch", "2"]))
    same("--prefill-batch 2 against the baseline", baseline, pb)
    whole_logits: dict = {}
    wh, _ = run("--prefill whole", parse(long_args + ["--prefill", "whole"]),
                logits=whole_logits)
    # whole-prompt prefill attends the prompt's unquantized K/V, chunked
    # prefill the int8 pool's (the reference's engine docstring says the
    # same): the first step's logits differ, so only they are compared
    tie_gate("--prefill whole against the baseline", baseline, wh, base_logits,
             {key: v for key, v in whole_logits.items() if key[1] == 0})
    wh_p, _ = run("--prefill whole, plain GEMMs",
                  parse(long_args + ["--prefill", "whole"]), gemm_plain=True)
    same("--prefill whole plain-GEMM re-run against --prefill whole", wh, wh_p)
    spec_logits: dict = {}
    sp, _ = run("spec w2a2 drafter, k 4", args, drafter="w2a2", logits=spec_logits)
    tie_gate("spec against the baseline", baseline, sp, base_logits, spec_logits)
    # the target drafting for itself: its drafts take the baseline decode's
    # one-token paged path, so they are accepted but at near ties, and the
    # rounds that emit several tokens, the bonus draw and the drafter's sync
    # after a fully accepted round all run
    spec_logits = {}
    ss, m_ss = run("spec self-drafter, k 4", args, drafter="self", logits=spec_logits)
    tie_gate("spec self-drafter against the baseline", baseline, ss, base_logits,
             spec_logits)
    if not m_ss["spec"]["accepted_tokens_per_step"] > 1:
        fail(f"features spec self-drafter: {m_ss['spec']['accepted_tokens_per_step']} "
             "tokens a slot-step, not above 1")
    del spec_logits, whole_logits

    # seeded sampling under w2a8_bs: a second run, --prefill-batch 2 and the
    # plain GEMMs give the same tokens, top-k 1 the greedy ones
    sargs = parse(long_args + FEAT_SAMPLING)
    a, _ = run("sampled w2a8_bs", sargs)
    b, _ = run("sampled w2a8_bs, again", sargs)
    same("sampled w2a8_bs: two runs", a, b)
    c, _ = run("sampled w2a8_bs, --prefill-batch 2",
               parse(long_args + ["--prefill-batch", "2"] + FEAT_SAMPLING))
    same("sampled w2a8_bs: --prefill-batch 2", a, c)
    d, _ = run("sampled w2a8_bs, plain GEMMs", sargs, gemm_plain=True)
    same("sampled w2a8_bs: plain-GEMM re-run", a, d)
    t1, _ = run("sampled w2a8_bs, top-k 1",
                parse(long_args + ["--temperature", "0.8", "--top-k", "1"]))
    same("sampled w2a8_bs, top-k 1: against the baseline", baseline, t1)
    diff = sum(x != y for x, y in zip(a, baseline))
    print(f"[14 features] sampled w2a8_bs: {diff}/{len(a)} requests differ from the "
          "baseline", flush=True)
    if not diff:
        fail("features sampled w2a8_bs: every request decoded greedily")
    # seeded sampling under spec mode, at spec-k 1 (a round of two drafter
    # forwards, not five): a second run, with --prefill-batch 2, and the
    # plain GEMMs give the same tokens, and top-k 1 leaves the baseline's
    # tokens only at near ties, as greedy spec decoding does
    k1 = ["--spec-k", str(FEAT_SAMPLED_SPEC_K)]
    sa, _ = run("sampled spec, k 1", parse(long_args + FEAT_SAMPLING + k1),
                drafter="w2a2")
    sb, _ = run("sampled spec, k 1, --prefill-batch 2",
                parse(long_args + FEAT_SAMPLING + k1 + ["--prefill-batch", "2"]),
                drafter="w2a2")
    same("sampled spec: a second run, with --prefill-batch 2", sa, sb)
    sp_p, _ = run("sampled spec, k 1, plain GEMMs", parse(long_args + FEAT_SAMPLING + k1),
                  drafter="w2a2", gemm_plain=True)
    same("sampled spec: plain-GEMM re-run", sa, sp_p)
    diff = sum(x != y for x, y in zip(sa, baseline))
    print(f"[14 features] sampled spec: {diff}/{len(sa)} requests differ from the "
          "baseline", flush=True)
    if not diff:
        fail("features sampled spec: every request decoded greedily")
    t1_logits: dict = {}
    st1, _ = run("sampled spec, k 1, top-k 1",
                 parse(long_args + ["--temperature", "0.8", "--top-k", "1"] + k1),
                 drafter="w2a2", logits=t1_logits)
    tie_gate("sampled spec, k 1, top-k 1 against the baseline", baseline, st1,
             base_logits, t1_logits)
    return out


def phase_tracer(torch, run, same, args, baseline, out: dict, smi: str) -> dict:
    """Phase 14's baseline again with a ``Tracer`` attached: its tokens and
    launches must be the baseline's; its Chrome trace is rendered by
    ``python -m repro_torch.analysis.report trace``, and the run's TTFT and
    TPOT percentiles printed."""
    from repro_torch.obs.trace import Tracer

    tracer = Tracer()
    traced, m = run("baseline, traced", args, tracer=tracer)
    same("the traced baseline against the baseline", baseline, traced)
    base = out["baseline (chunked, greedy)"]["launches"]
    if out["baseline, traced"]["launches"] != base:
        fail(f"features tracer: launches {out['baseline, traced']['launches']} "
             f"against the untraced baseline's {base}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        tracer.export(path)
        rendered = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.report", "trace", path],
            capture_output=True, text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
            timeout=120)
    if rendered.returncode != 0 or "Latency percentiles" not in rendered.stdout:
        fail(f"features tracer: the report did not render the trace: "
             f"{rendered.stderr[-2000:]}")
    lat, ph = m["latency"], m["phases"]
    print(f"[14 features] traced baseline: tokens and launches identical to the "
          f"untraced run; {len(m['metrics']['counters'])} counters; TTFT p50 "
          f"{1e3 * lat['ttft_s']['p50']:.2f} / p99 {1e3 * lat['ttft_s']['p99']:.2f} ms, "
          f"TPOT p50 {1e3 * lat['tpot_s']['p50']:.3f} / p99 "
          f"{1e3 * lat['tpot_s']['p99']:.3f} ms on {smi}; {ph['n_steps']} steps, phase "
          f"seconds {ph['total_s']}; the report's first lines:", flush=True)
    for line in rendered.stdout.splitlines()[:12]:
        print(f"    {line}", flush=True)
    return {"latency": lat, "phases": ph}


def phase_model_gemms(torch, dev, runs, m_rows) -> dict:
    """Rows 1-3 at a model's projection shapes: for each (label, (K, N)
    shapes, ops) of ``runs`` and M in ``m_rows``, ``lut_gemm`` (w2a2),
    ``lut_gemm_bs_fused`` (w2a8_bs) and ``dequant_matmul`` (w2a16) where
    ``ops`` names them, each bit-identical to its plain version, with its
    tiling, library and bound times."""
    from repro_torch.core import packing, quant
    from repro_torch.core.lut import product_lut
    from repro_torch.kernels.lut_dequant_matmul import (dequant_matmul_cuda,
                                                        dequant_matmul_plain)
    from repro_torch.kernels.lut_gemm import lut_gemm_cuda, lut_gemm_plain
    from repro_torch.kernels.lut_gemm_bitsliced import (lut_gemm_bs_fused_cuda,
                                                        lut_gemm_bs_fused_plain)

    gen = torch.Generator(device=dev).manual_seed(5)
    rows = {"lut_gemm": [], "dequant_matmul": [], "lut_gemm_bs_fused": []}

    def codes(shape, bits):
        return torch.randint(0, 2 ** bits, shape, generator=gen, device=dev,
                             dtype=torch.uint8)

    def check(name, cfg, M, K, N, kern, plain, library, n_bytes, peak, tiling):
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = (got - want).abs().max().item()
        k_ms = graph_ms(torch, kern)
        p_ms = graph_ms(torch, plain, reps=2, replays=2)
        l_ms = graph_ms(torch, library)
        b, by = bound_ms(n_bytes + M * N * 4, 2 * M * N * K, peak)
        rows[name].append({"kernel": name, "cfg": cfg, "M": M, "K": K, "N": N,
                           "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                           "library_ms": l_ms, "bound_ms": b, "bound_by": by, **tiling})
        print(f"  {name:17s} {cfg:14s} M={M:<3d} K={K:<5d} N={N:<5d} err={err:.3g} "
              f"kernel={k_ms:.5f}ms plain={p_ms:.5f}ms library={l_ms:.5f}ms "
              f"bound={b:.5f}ms ({by}); {bs_tiling_text(tiling)}", flush=True)
        if not (err == 0.0 and bool(torch.isfinite(got).all())):
            fail(f"{name} {cfg} M={M} K={K} N={N} is not bit-identical to its "
                 f"plain version: max_abs_err={err}")

    for label, shapes, ops in runs:
        for K, N in shapes:
            w2 = codes((N, K), 2)
            wp = packing.pack(w2, 2)
            cb = quant.uniform_codebook(2, device=dev).levels
            sc = torch.rand((N,), generator=gen, device=dev) * 0.02 + 0.01
            lut = product_lut(quant.uniform_codebook(2, device=dev),
                              quant.uniform_codebook(2, device=dev)).table
            planes = packing.pack_bitplanes_signed(w2, 2)
            w_lut = cb[w2.long()].to(torch.bfloat16)
            w_scaled = (cb[w2.long()] * sc[:, None]).to(torch.bfloat16)
            for M in m_rows:
                x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                if "lut_gemm" in ops:
                    ap = packing.pack(codes((M, K), 2), 2)
                    kw = dict(w_bits=2, a_bits=2, group_size=None)
                    check("lut_gemm", f"w2a2 {label}", M, K, N,
                          lambda: lut_gemm_cuda(ap, wp, lut, None, **kw),
                          lambda: lut_gemm_plain(ap, wp, lut, None, **kw),
                          lambda: torch.matmul(x, w_lut.T), nbytes(ap, wp, lut),
                          INT8_TC_OPS, dense_tiling("lut_gemm", M, N, K, 2, 2, None))
                if "lut_gemm_bs_fused" in ops:
                    kb = dict(w_bits=2, a_bits=8, group_size=None)
                    check("lut_gemm_bs_fused", f"w2a8_bs {label}", M, K, N,
                          lambda: lut_gemm_bs_fused_cuda(x, planes, sc, None, **kb),
                          lambda: lut_gemm_bs_fused_plain(x, planes, sc, None, **kb),
                          lambda: torch.matmul(x, w_scaled.T), nbytes(x, planes, sc),
                          INT8_TC_OPS, bs_tiling("lut_gemm_bs_fused", M, N, K, 2, None))
                if "dequant_matmul" in ops:
                    check("dequant_matmul", f"w2a16 {label}", M, K, N,
                          lambda: dequant_matmul_cuda(x, wp, cb, sc, bits=2,
                                                      group_size=None),
                          lambda: dequant_matmul_plain(x, wp, cb, sc, bits=2,
                                                       group_size=None),
                          lambda: torch.matmul(x, w_scaled.T), nbytes(x, wp, cb, sc),
                          BF16_TC_FLOPS, dense_tiling("dequant_matmul", M, N, K, 2, 16,
                                                      None))
            del w2, wp, planes, w_lut, w_scaled
    return rows


def window_view(torch, pool, sc, tbl, lens, window, bits):
    """The dequantized rows [lo_b, lo_b + L) of each sequence (L the longest
    window's rows), and the mask of those below lengths[b]: what SDPA over
    the window reads."""
    from repro_torch.kernels.ref import dequant_kv_tile

    bs = pool.shape[1]
    n = lens if window is None else torch.clamp(lens, max=window)
    lo = lens - n
    L = int(n.max())
    idx = lo[:, None] + torch.arange(L, device=lens.device)[None, :]
    valid = idx < lens[:, None]
    idx = torch.where(valid, idx, lo[:, None])
    blk = torch.gather(tbl, 1, idx // bs)
    return dequant_kv_tile(pool[blk, idx % bs], sc[blk, idx % bs], bits), valid


def phase_local_attention(torch, dev, head_shapes=LOCAL_HEADS, batches=(2, 4),
                          contexts=LOCAL_LENGTHS, windows=LOCAL_WINDOWS,
                          splits=LOCAL_SPLITS, edges=LOCAL_ATTN_EDGES,
                          check_resident: bool = True):
    """Rows 5 and 6 at ``head_shapes`` (KV, G, hd; the local models' by
    default, int8), every context length, batch and window, and at the window's
    edges (``edges``), each within TOL_ATTN of its plain version; SDPA over
    the window's rows, and a bound on the window's bytes. ``splits`` gives
    the lengths that also run the split (row 6) and its kv_splits."""
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as PA

    # the clusters of C hd-256 blocks (one an SM) the card holds at once,
    # against the table cluster_ranks reads (WIDE_RESIDENT): fewer would put
    # the single passes' clusters in a second wave
    lib = build.library("paged_attention")
    for G in (2, 16) if check_resident else ():
        resident = {C: lib.paged_attention_active_clusters(4, 8, G, 256, 512, 4 * C, 8,
                                                           1, C, 4, 0)
                    for C in range(1, PA.WIDE_MAX_CLUSTER + 1)}
        print(f"  hd 256, G {G}: clusters of C ranks resident at once: {resident} "
              f"(WIDE_RESIDENT {PA.WIDE_RESIDENT})", flush=True)
        if any(resident[C] < PA.WIDE_RESIDENT[C - 1] for C in resident):
            fail(f"the card holds fewer hd-256 G-{G} clusters than WIDE_RESIDENT says: "
                 f"{resident}")

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = {"paged_attention": [], "paged_attention_splitkv": []}
    grid = []
    for head in head_shapes:
        for B in batches:
            for n in contexts:
                bs = 512 if n >= 8192 else 16
                for w in windows:
                    grid.append((f"{head} len {n}", head, B, bs, (n,) * B, w, 1))
                    if n in splits:
                        grid.append((f"{head} len {n}", head, B, bs, (n,) * B, w,
                                     splits[n]))
    for label, head, B, bs, lengths, window, ks in grid + list(edges):
        KV, G, hd = head_shapes[head]
        nb = -(-max(lengths) // bs)
        ops = attention_operands(torch, dev, gen, B=B, KV=KV, G=G, hd=hd, bits=8,
                                 bs=bs, lengths=lengths, nb=nb, q_dtype=torch.bfloat16)
        q, kp, ksc, vp, vsc, tbl, lens = ops
        if ks == 1:
            name = "paged_attention"

            def kern():
                return PA.paged_attention_cuda(*ops, bits=8, window=window)

            def plain():
                return PA.paged_attention_plain(*ops, bits=8, window=window)
        else:
            name = "paged_attention_splitkv"

            def kern():
                return PA.paged_attention_splitkv_cuda(*ops, bits=8, kv_splits=ks,
                                                       window=window)

            def plain():
                return PA.paged_attention_splitkv_plain(*ops, bits=8, kv_splits=ks,
                                                        window=window)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= TOL_ATTN * scale
        k_ms = graph_ms(torch, kern)
        p_ms = graph_ms(torch, plain, reps=2, replays=2)
        # library: SDPA over the window's rows, pre-dequantized bf16
        kd, valid = window_view(torch, kp, ksc, tbl, lens, window, 8)
        vd, _ = window_view(torch, vp, vsc, tbl, lens, window, 8)

        def heads(d):
            return d.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).to(
                torch.bfloat16).contiguous()

        kh, vh = heads(kd), heads(vd)
        qs = q.reshape(B, KV * G, 1, hd).to(torch.bfloat16)
        mask = valid[:, None, None, :]
        l_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(qs, kh, vh,
                                                                      attn_mask=mask))
        del kd, vd, kh, vh
        n_rows = sum(min(n, window or n) for n in lengths)
        n_bytes = n_rows * KV * (hd + 4) * 2 + nbytes(q) + B * KV * G * hd * 4
        b, by = bound_ms(n_bytes, 4 * n_rows * KV * G * hd, BF16_TC_FLOPS)
        if ks == 1:
            C, active = PA.paged_attention_active_clusters(B, KV, G, hd, bs, nb, 8,
                                                           torch.bfloat16, window)
            how = f"cluster {C}, {B * KV * C} blocks, {active} clusters active at once"
            extra = dict(cluster=C, blocks=B * KV * C, active_clusters=active)
        else:
            K, C, active = PA.paged_attention_splitkv_active_clusters(
                B, KV, G, hd, bs, nb, 8, torch.bfloat16, ks, window)
            how = (f"{K} cluster(s) a head of {C} ranks, {B * KV * K * C} blocks"
                   f"{' + merge' if K > 1 else ''}, {active} clusters active at once")
            extra = dict(clusters_per_head=K, cluster=C, blocks=B * KV * K * C,
                         active_clusters=active)
        rows[name].append({"kernel": name, "label": label, "B": B, "KV": KV, "G": G,
                           "hd": hd, "bits": 8, "bs": bs, "lengths": list(lengths),
                           "nb": nb, "kv_splits": ks, "window": window, "q": "bf16",
                           "max_abs_err": err, "max_abs_plain": scale, "ms": k_ms,
                           "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b,
                           "bound_by": by, **extra})
        lens_txt = list(lengths) if len(set(lengths)) > 1 else lengths[0]
        print(f"  {name:23s} {label:24s} B={B} KV={KV} G={G} hd={hd} int8 bs={bs} "
              f"len={lens_txt} window={window} splits={ks} err={err:.3g} (max|plain| "
              f"{scale:.3g}) kernel={k_ms:.5f}ms plain={p_ms:.5f}ms "
              f"sdpa-window={l_ms:.5f}ms bound={b:.5f}ms ({by}, window bytes); {how}",
              flush=True)
        if not ok:
            fail(f"{name} {label} window {window} disagrees with its plain version: "
                 f"max_abs_err={err}, max|plain|={scale}")
        del ops, q, kp, ksc, vp, vsc
    return rows


def local_pool_bytes(engine) -> int:
    """Bytes of the pool tensors of ``engine``'s local layers."""
    return sum(t.numel() * t.element_size()
               for typ, layer in zip(engine.cfg.layer_types(), engine.caches)
               if typ == "local" for t in layer.values())


def ring_memory(torch, cfg, qparams, tag: str, what: str, smi: str) -> dict:
    """The engine's local-layer pool bytes and the device's peak while it is
    built, at RING_SLOTS slots and each of RING_MAX_LENS, without and with
    the ring (one engine at a time). Gate: the ring's bytes are the same at
    both lengths and are n_ring_blocks x block_size x the row's bytes (int8
    K and V codes and their f32 scales) x the local layers."""
    from repro_torch.serving import Engine

    if cfg.kv_cache_dtype != "int8":
        fail(f"{what} ring memory: the row bytes below are an int8 pool's")
    row = 2 * cfg.n_kv_heads * (cfg.hd + 4)
    n_local = cfg.layer_types().count("local")
    out: dict = {}
    for ring in (False, True):
        for max_len in RING_MAX_LENS:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            engine = Engine(cfg, qparams, n_slots=RING_SLOTS, max_len=max_len, ring=ring)
            torch.cuda.synchronize()
            rec = {"local_pool_bytes": local_pool_bytes(engine),
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "n_blocks": engine.n_blocks, "ring_len": engine.ring_len,
                   "n_ring_blocks": engine.n_ring_blocks}
            if ring:
                want = engine.n_ring_blocks * engine.block_size * row * n_local
                if rec["local_pool_bytes"] != want:
                    fail(f"{what} ring memory at {max_len}: local pools of "
                         f"{rec['local_pool_bytes']} bytes, want {want}")
            print(f"[{tag}] {what} {'ring' if ring else 'no ring'}, {RING_SLOTS} slots, "
                  f"max_len {max_len}: local-layer pools {rec['local_pool_bytes'] / 1e9:.4f}"
                  f" GB ({n_local} layers, {rec['n_ring_blocks'] if ring else rec['n_blocks']}"
                  f" blocks of 16 x {row} B rows), max_memory_allocated "
                  f"{rec['max_memory_allocated'] / 1e9:.3f} GB on {smi}", flush=True)
            out[f"{'ring' if ring else 'full'} {max_len}"] = rec
            del engine
    a, b = (out[f"ring {n}"]["local_pool_bytes"] for n in RING_MAX_LENS)
    if a != b:
        fail(f"{what} ring memory: the ring's local pools grow with max_len ({a}, {b})")
    return out


def planted_ring_pair(torch, cfg, qparams, wrappers, expect_launches, tag: str,
                      what: str, op: str) -> dict:
    """The planted decode at LOCAL_CTX (plant_long_context, kv_splits 1)
    without the ring, and on a ring engine holding the same rows: its global
    layers' pools copied, each slot's last ring_len blocks of every local
    layer copied into its ring. RING_STEPS decode steps on each, launch
    counts set to 0 before each run and read after; the ring run's first
    step checks every attention call against its plain version. Gate: the
    logits bitwise equal at every step, the tokens identical, the launches
    exact, the first step's calls within TOL_ATTN."""
    from repro_torch.serving import Engine, Request
    from repro_torch.serving import cache as C
    from repro_torch.serving.engine import _DECODE

    kw = dict(n_slots=LC_SLOTS, max_len=LOCAL_CTX + 4 * LC_BLOCK, block_size=LC_BLOCK,
              chunk_size=LC_BLOCK, kv_splits=1)
    full = Engine(cfg, qparams, **kw)
    reqs = {"full": plant_long_context(torch, full, LOCAL_CTX, RING_STEPS, seed=11),
            "ring": []}
    ring = Engine(cfg, qparams, ring=True, **kw)
    types = cfg.layer_types()
    for typ, src, dst in zip(types, full.caches, ring.caches):
        if typ != "local":
            for name in src:
                dst[name].copy_(src[name])
    nb_ctx = LOCAL_CTX // LC_BLOCK
    for i, (fs, rs) in enumerate(zip(full.slots, ring.slots)):
        rs.req = Request(uid=i, prompt=fs.prompt.copy(), max_new=RING_STEPS)
        reqs["ring"].append(rs.req)
        rs.state, rs.prompt, rs.pos, rs.next_input = _DECODE, fs.prompt.copy(), fs.pos, \
            fs.next_input
        rs.blocks = ring.pool.alloc(len(fs.blocks))
        rs.ring_blocks = ring.ring_pool.alloc(ring.ring_len)
        rs.ring_abs = C.ring_abs_row(rs.ring_blocks, ring.nb_spec)
        if rs.blocks != fs.blocks:
            fail(f"{what} planted ring: block ids {rs.blocks} != {fs.blocks}")
        for j in range(nb_ctx - ring.ring_len, nb_ctx):
            for typ, src, dst in zip(types, full.caches, ring.caches):
                if typ == "local":
                    for name in src:
                        dst[name][rs.ring_blocks[j % ring.ring_len]] = src[name][fs.blocks[j]]
    runs = {}
    for label, engine in (("full", full), ("ring", ring)):
        logits: list = []
        inner = engine._decode_fn

        def keep(*a, inner=inner, logits=logits):
            lg = inner(*a)
            logits.append(lg.clone())
            return lg

        engine._decode_fn = keep
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        errs: list = []
        with checked_attention_calls(errs) if label == "ring" else contextlib.nullcontext():
            engine._do_decode()
        for _ in range(RING_STEPS - 1):
            engine._do_decode()
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in wrappers.items()}
        expect_launches(f"{what} planted ring pair ({label})", launches,
                        {op: 7 * cfg.n_layers * RING_STEPS,
                         "paged_attention": cfg.n_layers * RING_STEPS})
        runs[label] = {"logits": logits, "tokens": [r.out for r in reqs[label]],
                       "errs": errs, "launches": launches}
    bitwise = all(torch.equal(a, b) for a, b in zip(runs["full"]["logits"],
                                                     runs["ring"]["logits"]))
    worst = max(rel_diff(b, a) for a, b in zip(runs["full"]["logits"],
                                               runs["ring"]["logits"]))
    errs = runs["ring"]["errs"]
    same_tokens = runs["full"]["tokens"] == runs["ring"]["tokens"]
    print(f"[{tag}] {what} planted {LOCAL_CTX}, ring of {ring.ring_len} blocks of "
          f"{LC_BLOCK} against the full table, {RING_STEPS} decode steps: logits "
          f"bitwise equal at every step {bitwise} (max rel diff {worst:.3g}), tokens "
          f"identical {same_tokens}; the ring's first step: {len(errs)} attention "
          f"calls each within {max(errs, default=float('nan')):.3g} of their plain "
          f"version; launches {runs['ring']['launches']}", flush=True)
    if not bitwise or not same_tokens:
        fail(f"{what} planted ring pair: logits bitwise {bitwise} (max rel diff {worst}),"
             f" tokens identical {same_tokens}")
    if len(errs) != cfg.n_layers or max(errs) > TOL_ATTN:
        fail(f"{what} planted ring pair: {len(errs)} checked attention calls (want "
             f"{cfg.n_layers}), max rel err {max(errs, default=None)}")
    out = {"ring_len": ring.ring_len, "logits_bitwise_equal": bitwise,
           "tokens_identical": same_tokens,
           "first_step_attention_call_max_rel_err": max(errs)}
    del full, ring, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def plain_cut_requests(serve, cfg, args) -> list:
    """The first PLAIN_CUT_REQUESTS of the CLI's requests, PLAIN_CUT_GEN
    tokens each: the plain-GEMM re-runs' cut."""
    reqs = serve.make_requests(cfg, args)[:PLAIN_CUT_REQUESTS]
    for r in reqs:
        r.max_new = PLAIN_CUT_GEN
    return reqs


def local_requests(cfg, lo: int, hi: int, count: int, gen: int, seed: int) -> list:
    """``count`` prompts of lo..hi tokens from numpy's default_rng(seed)."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(P)), max_new=gen)
            for i, P in enumerate(rng.integers(lo, hi + 1, count))]


def phase_local_model(torch, serve, wrappers: dict, gemms: dict, smi: str,
                      expect_launches, tag: str, arch: str, plans: tuple,
                      fixed_b: int, fixed_p: int) -> dict:
    """Phases 15 and 16 (see the module docstring): ``arch`` at full width
    and depth under each of ``plans`` (the first also runs the window-
    crossing engine, the planted decode and the fixed loop)."""
    plan_op = {"w2a2": "lut_gemm", "w2a16": "dequant_matmul",
               "w2a8_bs": "lut_gemm_bs_fused"}
    parse = serve.build_parser().parse_args
    out: dict = {}

    for i, plan in enumerate(plans):
        t_plan = time.perf_counter()
        op = plan_op[plan]
        args = parse(["--arch", arch, "--paged", "--plan", plan, "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        cfg, qparams = serve.prepare(args)
        packed_gb = torch.cuda.memory_allocated() / 1e9
        n = cfg.n_layers
        what = f"{arch} {plan}"
        res: dict = {}

        engine_run = functools.partial(counted_engine_run, torch, serve, wrappers,
                                       qparams, f"[{tag}] {what}", smi)

        # the engine: phase 5's 12 requests, exact launch counts (the
        # attention-plain re-run takes the window-crossing prompts below)
        res_k = engine_run("engine, 12 requests", cfg, args)
        expect_launches(f"{what} engine", res_k["launches"],
                        {op: 7 * n * forwards(res_k),
                         "paged_attention": n * res_k["metrics"]["decode_steps"]})
        # the GEMMs on their plain versions, cut to the first
        # PLAIN_CUT_REQUESTS requests and PLAIN_CUT_GEN tokens
        cut = parse(["--arch", arch, "--paged", "--plan", plan, "--device", "cuda",
                     "--gen", str(PLAIN_CUT_GEN)])
        reqs = plain_cut_requests(serve, cfg, args)
        cut_k = engine_run(f"cut to {PLAIN_CUT_REQUESTS} requests x "
                           f"{PLAIN_CUT_GEN} tokens", cfg, cut, requests=reqs)
        cut_p = engine_run("the same cut, plain GEMMs", plain_gemms(cfg), cut,
                           requests=plain_cut_requests(serve, cfg, args))
        if any(cut_p["launches"][g] for g in gemms):
            fail(f"{what}: the plain-GEMM run launched a GEMM kernel")
        same = sum(a.out == b.out for a, b in zip(cut_k["requests"], cut_p["requests"]))
        rel = rel_diff(cut_k["first_logits"], cut_p["first_logits"])
        print(f"[{tag}] {what}: plain-GEMM re-run (cut: the first "
              f"{PLAIN_CUT_REQUESTS} requests, {PLAIN_CUT_GEN} tokens, all {n} "
              f"layers): tokens identical for {same}/{len(reqs)} requests, first "
              f"decode step logits max rel diff {rel:.3g}", flush=True)
        if plan != "w2a16" and (same != len(reqs) or rel != 0.0):
            fail(f"{what}: kernel and plain-GEMM paths differ (tokens identical for "
                 f"{same}/{len(reqs)} requests, first-step logits by {rel})")
        if plan == "w2a16" and (same != len(reqs) or rel > TOL_LOGITS):
            fail(f"{what}: plain-GEMM re-run: tokens identical for {same}/{len(reqs)}, "
                 f"first-step logits differ by {rel} > {TOL_LOGITS}")
        res.update(launches=res_k["launches"], tok_per_s=res_k["tok_per_s"],
                   decode_step_ms=res_k["decode_step_ms"],
                   plain_gemm_tokens_identical=same, plain_gemm_logits_rel_diff=rel,
                   plain_gemm_decode_step_ms=cut_p["decode_step_ms"],
                   profile=phase_profile(torch, serve, cfg, qparams, args,
                                         f"[{tag} profile] {what}") if i == 0 else None)
        if i == 0:
            # prompts across the window: every local layer's decode reads
            # window rows of a longer context; the first step's attention
            # calls checked against their plain versions
            lo, hi, count, gen = LOCAL_CROSS
            cross_args = parse(["--arch", arch, "--paged", "--plan", plan, "--device",
                                "cuda", "--gen", str(gen), "--prompt-len",
                                str(LOCAL_CROSS_MAX_LEN - gen - 16)])
            errs: list = []
            cross_logits: dict = {}
            cr = engine_run(f"{count} prompts of {lo}-{hi} tokens", cfg, cross_args,
                            requests=local_requests(cfg, lo, hi, count, gen, 17),
                            check_first=errs, chunk_size=LOCAL_CROSS_CHUNK,
                            logits_by_step=cross_logits if arch == RING_CROSS_ARCH
                            else None)
            expect_launches(f"{what} window-crossing run", cr["launches"],
                            {op: 7 * n * forwards(cr),
                             "paged_attention": n * cr["metrics"]["decode_steps"]})
            if len(errs) != n or max(errs) > TOL_ATTN:
                fail(f"{what} window-crossing run: {len(errs)} checked attention "
                     f"calls (want {n}), max rel err {max(errs, default=None)}")
            cra = engine_run("the same prompts, attention plain", cfg, cross_args,
                             requests=local_requests(cfg, lo, hi, count, gen, 17),
                             attn_backend="ref", chunk_size=LOCAL_CROSS_CHUNK)
            # the model's conditioning: two plain formulations (the single
            # pass's oracle and the split's, kv_splits 3) on the same prompts
            crs = engine_run("the same prompts, attention plain, kv_splits 3", cfg,
                             parse(["--arch", arch, "--paged", "--plan", plan, "--device",
                                    "cuda", "--gen", str(gen), "--prompt-len",
                                    str(LOCAL_CROSS_MAX_LEN - gen - 16),
                                    "--kv-splits", "3"]),
                             requests=local_requests(cfg, lo, hi, count, gen, 17),
                             attn_backend="ref", chunk_size=LOCAL_CROSS_CHUNK)
            rel_c = rel_diff(cr["first_logits"], cra["first_logits"])
            cond_c = rel_diff(crs["first_logits"], cra["first_logits"])
            same_c = sum(a.out == b.out for a, b in zip(cr["requests"], cra["requests"]))
            print(f"[{tag}] {what} window-crossing run: the first step's {len(errs)} "
                  f"attention calls each within {max(errs):.3g} of their plain version; "
                  f"attention-plain run: tokens identical for {same_c}/{count}, first "
                  f"decode step logits max rel diff {rel_c:.3g}; two plain "
                  f"formulations (single pass, split 3) differ by {cond_c:.3g}", flush=True)
            if rel_c > TOL_SHARED_LOGITS:
                fail(f"{what} window-crossing run: attention kernel and plain "
                     f"first-step logits differ by {rel_c} > {TOL_SHARED_LOGITS}")
            res["window_crossing"] = {
                "decode_step_ms": cr["decode_step_ms"], "tok_per_s": cr["tok_per_s"],
                "launches": cr["launches"], "first_step_attention_call_max_rel_err":
                max(errs), "attn_plain_logits_rel_diff": rel_c,
                "attn_plain_tokens_identical": same_c,
                "plain_single_vs_plain_split_logits_rel_diff": cond_c}
            if arch == RING_CROSS_ARCH:
                # the same prompts through Engine(ring=True): the prefill
                # chunks attend over the ring's rows in the gathered path's
                # key chunks, the decode through the kernels on the ring's
                # absolute tables, so the logits are the run's bit for bit
                ring_logits: dict = {}
                crr = engine_run("the same prompts, --ring", cfg, cross_args,
                                 requests=local_requests(cfg, lo, hi, count, gen, 17),
                                 chunk_size=LOCAL_CROSS_CHUNK, ring=True,
                                 logits_by_step=ring_logits)
                expect_launches(f"{what} window-crossing ring run", crr["launches"],
                                {op: 7 * n * forwards(crr),
                                 "paged_attention": n * crr["metrics"]["decode_steps"]})
                want = [r.out for r in cr["requests"]]
                got = [r.out for r in crr["requests"]]
                n_diff = sum(a != b for w, g in zip(want, got) for a, b in zip(w, g))
                bitwise = ring_logits.keys() == cross_logits.keys() and all(
                    torch.equal(ring_logits[key], cross_logits[key]) for key in ring_logits)
                peak = crr["metrics"]["pool_blocks_peak"]
                print(f"[{tag}] {what} window-crossing run on the ring: {n_diff} of "
                      f"{sum(map(len, want))} tokens differ from the run without it; "
                      f"the logits of all {len(ring_logits)} steps bitwise equal "
                      f"{bitwise}; peak blocks a request {peak}; decode-only step "
                      f"{crr['decode_step_ms']:.3f} ms against {cr['decode_step_ms']:.3f}"
                      f" ms on {smi}", flush=True)
                if n_diff or not bitwise:
                    fail(f"{what} window-crossing ring run: {n_diff} tokens differ, "
                         f"logits bitwise equal {bitwise}")
                res["window_crossing_ring"] = {
                    "tokens_differing": n_diff, "logits_bitwise_equal": bitwise,
                    "pool_blocks_peak": peak, "decode_step_ms": crr["decode_step_ms"],
                    "launches": crr["launches"]}
                del cross_logits, ring_logits, crr
            # the planted decode at LOCAL_CTX: kv_splits LC_SPLITS and 1 on
            # byte-identical state, and the split on its plain version
            split = long_context_run(torch, cfg, qparams, LOCAL_CTX, LC_SPLITS, wrappers,
                                     label=tag)
            single = long_context_run(torch, cfg, qparams, LOCAL_CTX, 1, wrappers,
                                      label=tag)
            ref = long_context_run(torch, cfg, qparams, LOCAL_CTX, LC_SPLITS, wrappers,
                                   attn_backend="ref", warm=1, gen_steps=0,
                                   profile=False)
            ref1 = long_context_run(torch, cfg, qparams, LOCAL_CTX, 1, wrappers,
                                    attn_backend="ref", warm=1, gen_steps=0,
                                    profile=False)
            expect_launches(f"{what} planted split", split["launches"],
                            {op: 7 * n * split["steps"],
                             "paged_attention_splitkv": n * split["steps"]})
            expect_launches(f"{what} planted single", single["launches"],
                            {op: 7 * n * single["steps"],
                             "paged_attention": n * single["steps"]})
            call_errs = split["first_step_call_errs"] + single["first_step_call_errs"]
            if len(call_errs) != 2 * n or max(call_errs) > TOL_ATTN:
                fail(f"{what} planted {LOCAL_CTX}: {len(call_errs)} checked attention "
                     f"calls (want {2 * n}), max rel err {max(call_errs)}")
            rel_s = rel_diff(split["first_logits"], single["first_logits"])
            rel_r = rel_diff(split["first_logits"], ref["first_logits"])
            cond = rel_diff(ref1["first_logits"], ref["first_logits"])
            print(f"[{tag}] {what} planted {LOCAL_CTX}, {LC_SLOTS} slots: decode-only "
                  f"step {split['decode_step_ms']:.3f} ms (kv_splits {LC_SPLITS}) / "
                  f"{single['decode_step_ms']:.3f} ms (kv_splits 1) on {smi}; attention "
                  f"kernels {split['profile']['attention_device_ms_per_step']} / "
                  f"{single['profile']['attention_device_ms_per_step']} ms/step; the "
                  f"first step's {len(call_errs)} attention calls each within "
                  f"{max(call_errs):.3g} of their plain version; first-step logits "
                  f"split vs single {rel_s:.3g}, split kernel vs plain {rel_r:.3g}; "
                  f"the plain single pass vs the plain split {cond:.3g}", flush=True)
            if rel_s > TOL_SHARED_LOGITS or rel_r > TOL_SHARED_LOGITS:
                fail(f"{what} planted {LOCAL_CTX}: first-step logits differ (split vs "
                     f"single {rel_s}, split vs plain {rel_r}) > {TOL_SHARED_LOGITS}")
            res["planted"] = {"split_decode_step_ms": split["decode_step_ms"],
                              "single_decode_step_ms": single["decode_step_ms"],
                              "split_profile": split["profile"],
                              "single_profile": single["profile"],
                              "first_step_attention_call_max_rel_err": max(call_errs),
                              "logits_rel_diff_split_single": rel_s,
                              "logits_rel_diff_split_plain": rel_r,
                              "logits_rel_diff_plain_single_plain_split": cond}
            del split, single, ref, ref1
            gc.collect()
            torch.cuda.empty_cache()
            # the fixed loop with prompts past the window: every local
            # layer's ring wraps; the first decode step's kv_cache_attention
            # calls bit for bit against their plain version (the replay)
            fargs = parse(["--arch", arch, "--plan", plan, "--device", "cuda",
                           "--batch", str(fixed_b), "--prompt-len", str(fixed_p)])
            call_errs = []
            reset_counts(wrappers)
            fx = fixed_run(torch, serve, cfg, qparams, fargs, call_errs=call_errs)
            gen = fargs.gen
            expect_launches(f"{what} fixed", launch_counts(wrappers),
                            {op: 7 * n * gen, "kv_cache_attention": n * (gen - 1)})
            if len(call_errs) != n or max(call_errs) != 0.0:
                fail(f"{what} fixed: {len(call_errs)} checked kv_cache_attention "
                     f"calls (want {n}), max rel err {max(call_errs, default=None)} "
                     "(want 0)")
            rings = sorted({min(fixed_p + gen, cfg.window) for t in cfg.layer_types()
                            if t == "local"})
            print(f"[{tag}] {what} fixed loop, B {fixed_b} x P {fixed_p}, gen {gen}: "
                  f"prefill {fx['prefill_ms']:.1f} ms, decode {fx['tok_per_s']:.1f} "
                  f"tok/s, decode-only step {fx['decode_step_ms']:.3f} ms on {smi}; "
                  f"local rings of {rings} rows, wrapped; the first decode step's "
                  f"{len(call_errs)} kv_cache_attention calls identical to their "
                  "plain version", flush=True)
            res["fixed"] = {"prefill_ms": fx["prefill_ms"], "tok_per_s": fx["tok_per_s"],
                            "decode_step_ms": fx["decode_step_ms"]}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        res.update(packed_gb=packed_gb, peak_gb=peak_gb,
                   seconds=time.perf_counter() - t_plan)
        print(f"[{tag}] {what}: packed weights {packed_gb:.2f} GB, peak device memory "
              f"{peak_gb:.2f} GB; {res['seconds']:.1f}s", flush=True)
        if i == 0:
            # ring-paged local layers, after the serve's peak was read: the
            # pools' bytes with and without the ring (each engine resets the
            # peak), and the planted decode on both, bit for bit
            res["ring_memory"] = ring_memory(torch, cfg, qparams, tag, what, smi)
            res["ring_planted"] = planted_ring_pair(torch, cfg, qparams, wrappers,
                                                    expect_launches, tag, what, op)
        out[plan] = res
        del qparams, engine_run, res_k, cut_k, cut_p
        gc.collect()
        torch.cuda.empty_cache()
    return out


def recurrent_kernel_rows(torch, dev) -> dict:
    """Phase 4's rows of the recurrent slice: rows 1-3 at the recurrent
    models' projections (RECURRENT_GEMM_RUNS), row 5 at recurrentgemma's
    head (RG_HEAD) with its window at RG_CONTEXTS, B 4."""
    rows = phase_model_gemms(torch, dev, RECURRENT_GEMM_RUNS, RECURRENT_ROWS)
    rows.update(phase_local_attention(torch, dev, head_shapes=RG_HEAD, batches=(4,),
                                      contexts=RG_CONTEXTS, windows=(RG_WINDOW,),
                                      splits={}, edges=(), check_resident=False))
    return rows


def phase_recurrent_model(torch, serve, wrappers: dict, gemms: dict, smi: str,
                          expect_launches, tag: str, arch: str, plans: tuple,
                          fixed_plan: str, fixed_b: int, fixed_p: int) -> dict:
    """Phases 19 and 20 (see the module docstring): ``arch`` at full width
    and depth through the engine under each of ``plans``, its fixed loop
    under ``fixed_plan``; rwkv6's engine memory at RWKV_MEM_LENS."""
    from repro_torch.serving import Engine

    plan_op = {"w2a2": "lut_gemm", "w2a16": "dequant_matmul",
               "w2a8_bs": "lut_gemm_bs_fused"}
    parse = serve.build_parser().parse_args
    out: dict = {}

    for plan in plans:
        t_plan = time.perf_counter()
        op = plan_op[plan]
        args = parse(["--arch", arch, "--paged", "--plan", plan, "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        cfg, qparams = serve.prepare(args)
        packed_gb = torch.cuda.memory_allocated() / 1e9
        per_fwd = sum(GEMMS_PER_LAYER[t] for t in cfg.layer_types())
        n_attn = len(cfg.attention_layers())
        what = f"{arch} {plan}"
        res: dict = {}

        engine_run = functools.partial(counted_engine_run, torch, serve, wrappers,
                                       qparams, f"[{tag}] {what}", smi)

        # the engine: phase 5's 12 requests; the first decode step's
        # attention calls checked against their plain versions
        errs: list = []
        res_k = engine_run("engine, 12 requests", cfg, args, check_first=errs)
        expect_launches(f"{what} engine", res_k["launches"],
                        {op: per_fwd * forwards(res_k),
                         "paged_attention": n_attn * res_k["metrics"]["decode_steps"]})
        if len(errs) != n_attn or max(errs, default=0.0) > TOL_ATTN:
            fail(f"{what} engine: {len(errs)} checked attention calls (want {n_attn}), "
                 f"max rel err {max(errs, default=None)}")
        # the GEMMs, then the attention, on their plain versions, cut to the
        # first PLAIN_CUT_REQUESTS requests and PLAIN_CUT_GEN tokens
        cut = parse(["--arch", arch, "--paged", "--plan", plan, "--device", "cuda",
                     "--gen", str(PLAIN_CUT_GEN)])
        cut_k = engine_run(f"cut to {PLAIN_CUT_REQUESTS} requests x {PLAIN_CUT_GEN} "
                           "tokens", cfg, cut, requests=plain_cut_requests(serve, cfg, args))
        cut_p = engine_run("the same cut, plain GEMMs", plain_gemms(cfg), cut,
                           requests=plain_cut_requests(serve, cfg, args))
        if any(cut_p["launches"][g] for g in gemms):
            fail(f"{what}: the plain-GEMM run launched a GEMM kernel")
        same = sum(a.out == b.out for a, b in zip(cut_k["requests"], cut_p["requests"]))
        rel = rel_diff(cut_k["first_logits"], cut_p["first_logits"])
        print(f"[{tag}] {what}: plain-GEMM re-run (cut: the first {PLAIN_CUT_REQUESTS} "
              f"requests, {PLAIN_CUT_GEN} tokens, all {cfg.n_layers} layers): tokens "
              f"identical for {same}/{PLAIN_CUT_REQUESTS} requests, first decode step "
              f"logits max rel diff {rel:.3g}", flush=True)
        if same != PLAIN_CUT_REQUESTS or rel != 0.0:
            fail(f"{what}: kernel and plain-GEMM paths differ (tokens identical for "
                 f"{same}/{PLAIN_CUT_REQUESTS} requests, first-step logits by {rel})")
        res.update(launches=res_k["launches"], tok_per_s=res_k["tok_per_s"],
                   decode_step_ms=res_k["decode_step_ms"],
                   first_step_attention_call_max_rel_err=max(errs, default=None),
                   plain_gemm_tokens_identical=same, plain_gemm_logits_rel_diff=rel,
                   plain_gemm_decode_step_ms=cut_p["decode_step_ms"])
        if n_attn:
            cut_a = engine_run("the same cut, attention plain", cfg, cut,
                               requests=plain_cut_requests(serve, cfg, args),
                               attn_backend="ref")
            if cut_a["launches"]["paged_attention"]:
                fail(f"{what}: the attention-plain run launched paged_attention")
            same_a = sum(a.out == b.out for a, b in zip(cut_k["requests"],
                                                        cut_a["requests"]))
            rel_a = rel_diff(cut_k["first_logits"], cut_a["first_logits"])
            print(f"[{tag}] {what}: attention-plain re-run of the cut: tokens identical "
                  f"for {same_a}/{PLAIN_CUT_REQUESTS}, first decode step logits max rel "
                  f"diff {rel_a:.3g}", flush=True)
            if rel_a > TOL_LOGITS:
                fail(f"{what}: attention kernel and plain first-step logits differ by "
                     f"{rel_a} > {TOL_LOGITS}")
            res.update(attn_plain_tokens_identical=same_a, attn_plain_logits_rel_diff=rel_a)
            del cut_a
        if plan == plans[0]:
            prof = phase_profile(torch, serve, cfg, qparams, args,
                                 f"[{tag} profile] {what}")
            res["profile"] = prof
            rec = sum(prof["recurrence_device_ms_per_step"].values())
            print(f"[{tag}] {what}: a profiled step's device ms: dense GEMM kernels "
                  f"{prof['gemm_device_ms_per_step']:.3f}, attention kernels "
                  f"{sum(prof['attention_device_ms_per_step'].values()):.3f}, the "
                  f"recurrences' ATen ops {rec:.3f} "
                  f"({prof['recurrence_device_ms_per_step']}), the rest (norms, "
                  f"quantizers, head) {prof['other_device_ms_per_step'] - rec:.3f} of "
                  f"{prof['device_busy_ms_per_step']:.3f} busy", flush=True)
        if plan == fixed_plan:
            # the fixed loop at fixed_b x fixed_p: every state carried from the
            # prefill; the first decode step's kv_cache_attention calls bit
            # for bit against their plain version (the replay)
            fargs = parse(["--arch", arch, "--plan", plan, "--device", "cuda",
                           "--batch", str(fixed_b), "--prompt-len", str(fixed_p)])
            call_errs: list = []
            reset_counts(wrappers)
            fx = fixed_run(torch, serve, cfg, qparams, fargs, call_errs=call_errs)
            gen = fargs.gen
            expect_launches(f"{what} fixed", launch_counts(wrappers),
                            {op: per_fwd * gen, "kv_cache_attention": n_attn * (gen - 1)})
            if len(call_errs) != n_attn or max(call_errs, default=0.0) != 0.0:
                fail(f"{what} fixed: {len(call_errs)} checked kv_cache_attention calls "
                     f"(want {n_attn}), max rel err {max(call_errs, default=None)} "
                     "(want 0)")
            # the same prompts' prefill once more, the first GEMM call at each
            # weight shape held against its plain version: the prefill's own
            # rows (M = B x P) on the kernel's tiling for them (exact sums:
            # an integer table's, or the tied replay's)
            from repro_torch.launch import steps as St
            tokens = torch.from_numpy(np.random.default_rng(fargs.seed).integers(
                0, cfg.vocab_size, size=(fixed_b, fixed_p))).to("cuda")
            pre_errs: dict = {}
            with checked_first_calls(op, pre_errs):
                St.make_prefill_step(cfg, max_len=fixed_p + gen)(qparams,
                                                                 {"tokens": tokens})
            torch.cuda.synchronize()
            n_shapes = len(dict((t, s) for t, s, _ in RECURRENT_GEMM_RUNS)[tag.split()[1]])
            print(f"[{tag}] {what} fixed loop: its prefill's first {op} call at each "
                  f"packed weight shape against the plain version: (M, max rel err) "
                  f"{pre_errs}", flush=True)
            if len(pre_errs) != n_shapes or any(e != 0.0 for _, e in pre_errs.values()):
                fail(f"{what} fixed: prefill {op} calls at {len(pre_errs)} weight shapes "
                     f"(want {n_shapes}) differ from their plain version: {pre_errs}")
            del tokens
            # the plain-GEMM and plain-attention pairs at RECURRENT_PLAIN_P rows
            pp = min(fixed_p, RECURRENT_PLAIN_P)
            pargs = parse(["--arch", arch, "--plan", plan, "--device", "cuda",
                           "--batch", str(fixed_b), "--prompt-len", str(pp),
                           "--gen", str(PLAIN_CUT_GEN)])
            fk = fixed_run(torch, serve, cfg, qparams, pargs)
            reset_counts(wrappers)
            fp = fixed_run(torch, serve, plain_gemms(cfg), qparams, pargs)
            if any(launch_counts(wrappers)[g] for g in gemms):
                fail(f"{what} fixed: the plain-GEMM run launched a GEMM kernel")
            fa = fixed_run(torch, serve, cfg, qparams, pargs, attn_backend="ref")
            same_f = [int((fk["tokens"] == r["tokens"]).all(axis=1).sum()) for r in (fp, fa)]
            rel_f = [rel_diff(fk["first_logits"], r["first_logits"]) for r in (fp, fa)]
            print(f"[{tag}] {what} fixed loop, B {fixed_b} x P {fixed_p}, gen {gen}: "
                  f"prefill {fx['prefill_ms']:.1f} ms, decode {fx['tok_per_s']:.1f} tok/s, "
                  f"decode-only step {fx['decode_step_ms']:.3f} ms on {smi}; the first "
                  f"decode step's {len(call_errs)} kv_cache_attention calls identical to "
                  f"their plain version; at P {pp}, {PLAIN_CUT_GEN} tokens: plain-GEMM "
                  f"run tokens identical for {same_f[0]}/{fixed_b} rows, logits "
                  f"{rel_f[0]:.3g}; attention-plain run {same_f[1]}/{fixed_b}, logits "
                  f"{rel_f[1]:.3g}", flush=True)
            if same_f != [fixed_b, fixed_b] or rel_f != [0.0, 0.0]:
                fail(f"{what} fixed: the plain-GEMM / plain-attention runs differ "
                     f"(tokens identical {same_f}, first-step logits {rel_f})")
            res["fixed"] = {"prefill_ms": fx["prefill_ms"], "tok_per_s": fx["tok_per_s"],
                            "decode_step_ms": fx["decode_step_ms"],
                            "prefill_first_call_errs": {str(k): v for k, v in
                                                        pre_errs.items()},
                            "plain_gemm_logits_rel_diff": rel_f[0],
                            "attn_plain_logits_rel_diff": rel_f[1]}
            del fx, fk, fp, fa
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        res.update(packed_gb=packed_gb, peak_gb=peak_gb)
        if not n_attn and plan == plans[0]:
            # no pool: the engine's memory does not grow with max_len
            peaks = {}
            for max_len in RWKV_MEM_LENS:
                gc.collect()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                eng = Engine(cfg, qparams, n_slots=args.batch, max_len=max_len,
                             block_size=args.block_size)
                for r in local_requests(cfg, 4, 32, args.batch, PLAIN_CUT_GEN, 23):
                    eng.submit(r)
                eng.run()
                torch.cuda.synchronize()
                peaks[max_len] = (torch.cuda.max_memory_allocated() - base) / 1e9
                del eng
            print(f"[{tag}] {what}: engine peak device memory above the weights, "
                  f"{args.batch} slots, by max_len: {peaks} GB (no pool: the state is "
                  "O(1))", flush=True)
            if max(peaks.values()) - min(peaks.values()) > 1e-3:
                fail(f"{what}: the engine's peak memory grows with max_len: {peaks}")
            res["engine_peak_gb_by_max_len"] = peaks
        res["seconds"] = time.perf_counter() - t_plan
        print(f"[{tag}] {what}: packed weights {packed_gb:.2f} GB, peak device memory "
              f"{peak_gb:.2f} GB; {res['seconds']:.1f}s", flush=True)
        out[plan] = res
        del qparams, engine_run, res_k, cut_k, cut_p
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_cnn(torch, dev, smi: str, rows: dict) -> dict:
    """Phase 17 (see the module docstring): deepgemm-cnn at full width,
    batch CNN_BATCH of 32x32x3 inputs, under each of CNN_PLANS. Per layer:
    the lut_gemm call conv2d_serve makes (its operands taken from the
    registry as the call runs) against its plain version, exactly, and a
    k-means layer also against the order-free ``ref_lut_gemm`` within
    TOL_LUT_FLOAT of max|plain|; its tiling, and its time beside the plain
    version's, torch.matmul of the bf16 patches against the bf16
    dequantized filters, F.conv2d (f32, no TF32) on the layer's input, and
    the byte / operation bound. Per plan: one forward through the kernels
    with exactly 9 launches, the plain-backend stack bit for bit, the
    feature cosine against the fp32 stack above CNN_MIN_COSINE, and the
    forward's time."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import conv
    from repro_torch.core.lut import ProductLUT
    from repro_torch.core.qlinear import QuantPolicy, dequant_weight
    from repro_torch.kernels import registry
    from repro_torch.kernels.lut_gemm import lut_gemm_cuda, lut_gemm_plain
    from repro_torch.kernels.ref import ref_lut_gemm
    from repro_torch.models import cnn

    cfg = get_config("deepgemm-cnn")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = cnn.init_params(cfg, gen, dev)
    x = torch.randn((CNN_BATCH, cfg.img_hw, cfg.img_hw, cfg.in_ch), generator=gen,
                    device=dev)
    n_conv = len(params)
    out = {}
    with torch.inference_mode():
        y_fp = cnn.forward_plain(params, x)
        fp_ms = loop_ms(torch, lambda: cnn.forward_plain(params, x), reps=CNN_FORWARD_REPS)
        print(f"[17 cnn] {cfg.name}: {n_conv} convs 3x3 (widths "
              f"{cnn.channels(cfg)}), batch {CNN_BATCH} x {cfg.img_hw}x{cfg.img_hw}x"
              f"{cfg.in_ch}; fp32 forward {fp_ms:.3f} ms on {smi}", flush=True)
        for label, wb, ab, kmeans in CNN_PLANS:
            qws = cnn.quantize(params, QuantPolicy(w_bits=wb, a_bits=ab, nonuniform=kmeans))
            layers = []
            h = x
            for i, (p, qw) in enumerate(zip(params, qws)):
                calls = []
                with registry.watched(("lut_gemm",), lambda op, arrays, static, y:
                                      calls.append((arrays, static, y))):
                    h_next = torch.relu(conv.conv2d_serve(qw, h, 3, 3, a_bits=ab))
                if len(calls) != 1:
                    fail(f"cnn {label} layer {i}: {len(calls)} lut_gemm calls, want 1")
                (ap, wp, table, _), kw, got = calls[0]
                M, K, N = ap.shape[0], qw.k_padded, qw.out_features
                want = lut_gemm_plain(ap, wp, table, None, **kw)
                err = (got - want).abs().max().item()
                peak = max(want.abs().max().item(), 1e-30)
                if err != 0.0:
                    fail(f"cnn {label} layer {i}: lut_gemm differs from its plain "
                         f"version by {err} ({err / peak} of max|plain|)")
                free = None
                if kmeans:        # the order-free oracle, not tied to the walk
                    free = (got - ref_lut_gemm(ap, wp, ProductLUT(table, wb, ab))
                            ).abs().max().item() / peak
                    if not free <= TOL_LUT_FLOAT:
                        fail(f"cnn {label} layer {i}: lut_gemm against ref_lut_gemm "
                             f"{free} of max|plain| > {TOL_LUT_FLOAT}")
                k_ms = graph_ms(torch, lambda: lut_gemm_cuda(ap, wp, table, None, **kw))
                p_ms = loop_ms(torch, lambda: lut_gemm_plain(ap, wp, table, None, **kw),
                               reps=1)
                w_deq = dequant_weight(qw)                          # (fan_in, cout)
                patches, _ = conv.im2col(h, 3, 3)
                pb, wbf = patches.to(torch.bfloat16), w_deq.to(torch.bfloat16)
                l_ms = graph_ms(torch, lambda: torch.matmul(pb, wbf))
                h_nchw = h.permute(0, 3, 1, 2).contiguous()
                w4 = w_deq.reshape(p["cin"], 3, 3, N).permute(3, 0, 1, 2).contiguous()
                c_ms = loop_ms(torch, lambda: F.conv2d(h_nchw, w4, padding=1))
                b, by = bound_ms(nbytes(ap, wp, table) + M * N * 4, 2 * M * N * K,
                                 INT8_TC_OPS)
                tiling = dense_tiling("lut_gemm", M, N, K, wb, ab, None)
                row = {"kernel": "lut_gemm", "cfg": f"cnn {label} conv{i}", "M": M,
                       "K": K, "N": N, "max_abs_err": err, "rel_err": err / peak,
                       "order_free_rel_err": free, "ms": k_ms, "plain_ms": p_ms,
                       "library_ms": l_ms, "conv2d_ms": c_ms, "bound_ms": b,
                       "bound_by": by, **tiling}
                rows["lut_gemm"].append(row)
                layers.append(row)
                print(f"[17 cnn] {label} conv{i} M={M} K={K} N={N}: err {err:.3g}"
                      + (f", against ref_lut_gemm {free:.3g} of max|plain| (tolerance "
                         f"{TOL_LUT_FLOAT})" if kmeans else "")
                      + f" | lut_gemm {1e3 * k_ms:.2f} us, plain {1e3 * p_ms:.1f} us, "
                      f"torch.matmul bf16 {1e3 * l_ms:.2f} us, F.conv2d f32 "
                      f"{1e3 * c_ms:.2f} us, bound {1e3 * b:.2f} us ({by}); "
                      f"{bs_tiling_text(tiling)}", flush=True)
                h = h_next
            lut_gemm_cuda.launches = 0
            y = cnn.forward_lut(qws, x, a_bits=ab)
            if lut_gemm_cuda.launches != n_conv:
                fail(f"cnn {label}: {lut_gemm_cuda.launches} lut_gemm launches in one "
                     f"forward, expected {n_conv}")
            if not torch.equal(y, h.mean((1, 2))):
                fail(f"cnn {label}: the forward differs from its layer-by-layer run")
            y_p = cnn.forward_lut(qws, x, a_bits=ab, backend="ref")
            if lut_gemm_cuda.launches != n_conv:
                fail(f"cnn {label}: the plain-backend stack launched lut_gemm")
            if not torch.equal(y, y_p):
                fail(f"cnn {label}: the kernel stack differs from the plain-backend "
                     f"stack by {(y - y_p).abs().max().item()}")
            q_ms = loop_ms(torch, lambda: cnn.forward_lut(qws, x, a_bits=ab),
                           reps=CNN_FORWARD_REPS)
            cos = float((y_fp * y).sum() / (y_fp.norm() * y.norm() + 1e-9))
            print(f"[17 cnn] {label}: forward {q_ms:.3f} ms ({n_conv} lut_gemm launches, "
                  f"layers {sum(r['ms'] for r in layers):.4f} ms of lut_gemm) against "
                  f"fp32 {fp_ms:.3f} ms; plain-backend stack bit for bit; feature "
                  f"cosine {cos:.4f} on {smi}", flush=True)
            if not cos > CNN_MIN_COSINE:
                fail(f"cnn {label}: feature cosine {cos} <= {CNN_MIN_COSINE}")
            out[label] = {"forward_ms": q_ms, "fp32_forward_ms": fp_ms, "cosine": cos,
                          "launches": n_conv, "layers": layers}
            del qws
    return out


def phase_quant_front(torch, dev, serve, wrappers: dict, gemms: dict, smi: str,
                      expect_launches, rows: dict) -> dict:
    """Phase 18 (see the module docstring): qwen1.5-0.5b at full width,
    QF_LAYERS deep, through the paged engine under each of QF_RUNS."""
    from repro_torch.models import lm

    parse = serve.build_parser().parse_args
    base = ["--arch", "qwen1.5-0.5b", "--paged", "--device", dev.type]
    n = QF_LAYERS
    print(f"[18 quant] qwen1.5-0.5b at full width, cut to its first {n} of 24 layers",
          flush=True)
    out: dict = {}

    def run(label, cfg, qparams, args, op, *, requests=None, logits=None, check=None):
        for w in wrappers.values():
            w.launches = 0
        cap: dict = {}
        res = run_engine(torch, serve, cfg, qparams, args, cap, requests=requests,
                         logits_by_step=logits, check_first=check,
                         check_ops=(op,) if check is not None else None)
        launches = {name: w.launches for name, w in wrappers.items()}
        m = res["metrics"]
        if cfg.quant is not None and getattr(cfg.quant, "backend", "auto") == "ref":
            if any(gemms[g].launches for g in gemms):
                fail(f"quant {label}: the plain-GEMM run launched a GEMM kernel")
        else:
            forwards = m["decode_steps"] + m["prefill_chunks"]
            expect_launches(f"quant {label}", launches,
                            {**({op: 7 * n * forwards} if op else {}),
                             "paged_attention": n * m["decode_steps"]})
        return res, cap, launches

    for label, flags, op in QF_RUNS:
        t0 = time.perf_counter()
        args = parse(base + flags)
        cfg, desc = serve.config_for(args)
        cfg = dataclasses.replace(cfg, n_layers=n)             # the first n layers
        info: dict = {}
        qparams = serve.pack_params(cfg, args, desc, calibrate=args.a_scale == "static",
                                    info=info)
        leaves = lm.qweights(qparams)
        stamped = sum(qw.a_sc is not None for qw in leaves.values())
        res, cap, launches = run(label, cfg, qparams, args, op)
        m = res["metrics"]
        rec = {"tok_per_s": res["tok_per_s"], "decode_step_ms": res["decode_step_ms"],
               "launches": launches, "a_sc_leaves": stamped,
               "tokens": [r.out for r in res["requests"]],
               "first_logits": cap["first_logits"].cpu()}
        line = (f"[18 quant] {label}: {len(res['requests'])} requests, {res['tokens']} "
                f"tokens, {res['tok_per_s']:.1f} tok/s, decode-only step "
                f"{res['decode_step_ms']:.3f} ms on {smi} | launches "
                f"{ {k: v for k, v in launches.items() if v} } | a_sc on {stamped} of "
                f"{len(leaves)} leaves")
        if "calib_s" in info:
            rec["calib_s"] = info["calib_s"]
            line += (f" | calibration {info['calib_s']:.3f} s over "
                     f"{len(info['act_scales'])} layer classes")
        print(line, flush=True)
        if label == "static w2a2":
            want = [p for p, qw in leaves.items() if qw.kernel == "lut_gemm"]
            if stamped != 7 * n or stamped != len(want) or any(
                    leaves[p].a_sc is None for p in want):
                fail(f"quant {label}: a_sc on {stamped} leaves, want every one of the "
                     f"{len(want)} lut_gemm leaves ({7 * n})")
        elif stamped:
            fail(f"quant {label}: {stamped} leaves carry a static scale, want none")
        if label.startswith("kmeans"):
            w_up = leaves["layers.0.mlp.w_up.qw"]
            lv = w_up.codebook
            print(f"[18 quant] {label}: layers.0.mlp.w_up's k-means levels "
                  f"{[round(v, 6) for v in lv.tolist()]}; plut "
                  f"{'float' if w_up.plut is not None else 'none'}", flush=True)
            if bool((lv == lv.round()).all()):
                fail(f"quant {label}: the k-means codebook is integer-valued")
            rec.update(kernel_rows(torch, dev, w_up, op, rows, label))
        if label in ("kmeans w2a2", "kmeans w2a16", "static w2a2"):
            # the same cut of the stream through the kernels and the plain GEMMs
            cut = parse(base + flags + ["--gen", str(PLAIN_CUT_GEN)])
            reqs = plain_cut_requests(serve, cfg, args)
            lk, lp, errs = {}, {}, []
            res_k, cap_k, _ = run(label + " cut", cfg, qparams, cut, op, requests=reqs,
                                  logits=lk, check=errs)
            res_p, cap_p, _ = run(label + " plain", plain_gemms(cfg), qparams, cut, op,
                                  requests=plain_cut_requests(serve, cfg, args),
                                  logits=lp)
            tk = [r.out for r in res_k["requests"]]
            tp_ = [r.out for r in res_p["requests"]]
            rel = rel_diff(cap_k["first_logits"], cap_p["first_logits"])
            ties, worst = near_ties(tp_, tk, lp, lk)
            same = sum(a == b for a, b in zip(tk, tp_))
            print(f"[18 quant] {label}: against its plain-GEMM re-run (the first "
                  f"{PLAIN_CUT_REQUESTS} requests, {PLAIN_CUT_GEN} tokens, "
                  f"{res_p['tok_per_s']:.1f} tok/s): tokens identical for {same}/"
                  f"{len(tk)}, divergences at (uid, step, margin) {ties}; first-step "
                  f"logits {rel:.3g} of max|logit|; the first step's {len(errs)} {op} "
                  f"calls within {max(errs):.3g} of plain", flush=True)
            if len(errs) != 7 * n:
                fail(f"quant {label}: {len(errs)} checked first-step {op} calls, "
                     f"want {7 * n}")
            if same != len(tk) or rel != 0.0 or max(errs) != 0.0:
                fail(f"quant {label}: kernel and plain runs differ (tokens {same}/"
                     f"{len(tk)}, first-step logits {rel}, calls {max(errs)})")
            rec.update({"plain_tokens_identical": same, "plain_logits_rel_diff": rel,
                        "near_ties": ties, "shared_context_logits_rel": worst,
                        "first_step_call_max_rel_err": max(errs),
                        "plain_tok_per_s": res_p["tok_per_s"]})
        rec["seconds"] = time.perf_counter() - t0
        out[label] = rec
        del qparams, leaves
        gc.collect()
        torch.cuda.empty_cache()
    st, dy = out["static w2a8_bs"], out["dynamic w2a8_bs"]
    same = st["tokens"] == dy["tokens"] and torch.equal(st["first_logits"],
                                                        dy["first_logits"])
    print(f"[18 quant] static w2a8_bs against dynamic w2a8_bs: tokens and first-step "
          f"logits bit for bit: {same}", flush=True)
    if not same:
        fail("quant: --plan w2a8_bs --a-scale static serves other tokens or logits "
             "than the dynamic plan")
    for rec in out.values():
        del rec["tokens"], rec["first_logits"]
    return out


def kernel_rows(torch, dev, qw, op: str, rows: dict, label: str) -> dict:
    """Rows 1-2 on a k-means leaf of the served model at QF_KERNEL_ROWS:
    lut_gemm with its float product table, or dequant_matmul with its float
    codebook (the separately rounded branch of csrc/dense_dequant.cuh), each
    exact against its tied replay, and lut_gemm also within TOL_LUT_FLOAT of
    max|plain| against the order-free ref_lut_gemm; each with its plain,
    library (bf16 torch.matmul) and bound times."""
    from repro_torch.core import packing
    from repro_torch.core.qlinear import dequant_weight
    from repro_torch.kernels.lut_dequant_matmul import (dequant_matmul_cuda,
                                                        dequant_matmul_plain)
    from repro_torch.core.lut import ProductLUT
    from repro_torch.kernels.lut_gemm import lut_gemm_cuda, lut_gemm_plain
    from repro_torch.kernels.ref import ref_lut_gemm

    gen = torch.Generator(device=dev).manual_seed(27)
    K, N = qw.k_padded, qw.out_features
    w_deq = dequant_weight(qw).to(torch.bfloat16)
    rec = {}
    for M in QF_KERNEL_ROWS:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        if op == "lut_gemm":
            a_idx = torch.randint(0, 2 ** qw.a_bits, (M, K), generator=gen, device=dev,
                                  dtype=torch.uint8)
            ap = packing.pack(a_idx, qw.a_bits)
            kw = dict(w_bits=qw.bits, a_bits=qw.a_bits, float_table=qw.nonuniform)
            call = (lambda: lut_gemm_cuda(ap, qw.packed, qw.plut, None, **kw))
            order_free = (lambda: ref_lut_gemm(ap, qw.packed,
                                               ProductLUT(qw.plut, qw.bits, qw.a_bits)))
            plain = (lambda: lut_gemm_plain(ap, qw.packed, qw.plut, None, **kw))
            b, by = bound_ms(nbytes(ap, qw.packed, qw.plut) + M * N * 4, 2 * M * N * K,
                             INT8_TC_OPS)
            tiling = dense_tiling("lut_gemm", M, N, K, qw.bits, qw.a_bits, None)
        else:
            kw = dict(bits=qw.bits)
            call = (lambda: dequant_matmul_cuda(x, qw.packed, qw.codebook, qw.scales, **kw))
            plain = (lambda: dequant_matmul_plain(x, qw.packed, qw.codebook, qw.scales,
                                                  **kw))
            b, by = bound_ms(nbytes(x, qw.packed, qw.codebook, qw.scales) + M * N * 4,
                             2 * M * N * K, BF16_TC_FLOPS)
            tiling = dense_tiling("dequant_matmul", M, N, K, qw.bits, 16, None)
            order_free = None
        got = call()
        torch.cuda.synchronize()
        want = plain()
        err = (got - want).abs().max().item()
        peak = max(want.abs().max().item(), 1e-30)
        rel = err / peak
        free = None
        if order_free is not None:
            free = (got - order_free()).abs().max().item() / peak
        k_ms = graph_ms(torch, call)
        p_ms = graph_ms(torch, plain, reps=3, replays=3)
        l_ms = graph_ms(torch, lambda: torch.matmul(x, w_deq))
        row = {"kernel": op, "cfg": f"{label} (qwen w_up)", "M": M, "K": K, "N": N,
               "max_abs_err": err, "rel_err": rel, "order_free_rel_err": free,
               "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b,
               "bound_by": by, **tiling}
        rows[op].append(row)
        rec[f"kernel_M{M}"] = row
        print(f"[18 quant] {op} {label} M={M} K={K} N={N}: err {err:.3g} ({rel:.3g} "
              f"rel)" + (f", against ref_lut_gemm {free:.3g} of max|plain| (tolerance "
                         f"{TOL_LUT_FLOAT})" if free is not None else "")
              + f" | kernel {1e3 * k_ms:.2f} us, plain {1e3 * p_ms:.1f} us, "
              f"library {1e3 * l_ms:.2f} us, bound {1e3 * b:.2f} us ({by}); "
              f"{bs_tiling_text(tiling)}", flush=True)
        if err != 0.0:
            fail(f"{op} {label} M={M}: kernel against plain {err} ({rel} of max|plain|)")
        if free is not None and not free <= TOL_LUT_FLOAT:
            fail(f"{op} {label} M={M}: kernel against ref_lut_gemm {free} of "
                 f"max|plain| > {TOL_LUT_FLOAT}")
    return rec


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
    from repro_torch.kernels.paged_attention import (auto_kv_splits,
                                                     paged_attention_cuda,
                                                     paged_attention_splitkv_cuda)
    from repro_torch.launch import mesh, serve
    from repro_torch.models import lm

    t_start = time.perf_counter()
    starts: dict = {}

    def mark(name):
        """Phase ``name`` starts now; the run's last line of phases prints
        each phase's seconds."""
        starts[name] = time.perf_counter() - t_start
        print(f"[{name}] started at {starts[name]:.1f}s", flush=True)

    mark("1-3 device, settings, build")
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

    mark("4 kernels")
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
    print(f"[4 kernels] the local slice's shapes: rows 1-3 at gemma3-12b's and "
          f"h2o-danube-3-4b's projections, rows 5 and 6 with a window at hd 256 and "
          f"120 (done so far at {time.perf_counter() - t_start:.1f}s)", flush=True)
    for name, more in {**phase_model_gemms(torch, dev, LOCAL_GEMM_RUNS, LOCAL_ROWS),
                       **phase_local_attention(torch, dev)}.items():
        rows[name] += more
    print(f"[4 kernels] the recurrent slice's shapes: rows 1-3 at recurrentgemma-9b's "
          f"and rwkv6-1.6b's projections, row 5 at recurrentgemma's head (KV 1, G 16, "
          f"hd 256), window {RG_WINDOW} (row 9 there is in the kv_cache_attention rows "
          f"above; done so far at {time.perf_counter() - t_start:.1f}s)", flush=True)
    for name, more in recurrent_kernel_rows(torch, dev).items():
        rows[name] += more
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

    def expect_launches(what, launches, counts: dict):
        """The named wrappers launched exactly ``counts``, the others 0."""
        want = {name: counts.get(name, 0) for name in wrappers}
        if launches != want:
            fail(f"{what}: launches {launches}, expected {want}")

    results = {}
    mark("5-7 engine, plain, profile")
    for plan, op in plan_op.items():
        args = serve.build_parser().parse_args(
            ["--arch", "qwen1.5-0.5b", "--paged", "--plan", plan,
             "--device", "cuda"])
        cfg, qparams = serve.prepare(args)
        cap_k: dict = {}
        reset_counts(wrappers)
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
        # versions (attention stays on its kernel), cut to the first
        # PLAIN_CUT_REQUESTS requests and PLAIN_CUT_GEN tokens, against a
        # kernel run of the same cut
        cfg_p = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, backend="ref"))
        cut_args = serve.build_parser().parse_args(
            ["--arch", "qwen1.5-0.5b", "--paged", "--plan", plan, "--device", "cuda",
             "--gen", str(PLAIN_CUT_GEN)])
        cap_c: dict = {}
        res_c = run_engine(torch, serve, cfg, qparams, cut_args, cap_c,
                           requests=plain_cut_requests(serve, cfg, args))
        cap_p: dict = {}
        reset_counts(wrappers)
        res_p = run_engine(torch, serve, cfg_p, qparams, cut_args, cap_p,
                           requests=plain_cut_requests(serve, cfg, args))
        if any(gemms[name].launches for name in gemms):
            fail("the plain-GEMM run launched a GEMM kernel")
        toks_k = [r.out for r in res_k["requests"]]
        toks_c = [r.out for r in res_c["requests"]]
        same = sum(a == r.out for a, r in zip(toks_c, res_p["requests"]))
        rel = rel_diff(cap_c["first_logits"], cap_p["first_logits"])
        print(f"[6 plain] {plan}: plain-GEMM run (cut: the first {PLAIN_CUT_REQUESTS} "
              f"requests, {PLAIN_CUT_GEN} tokens) {res_p['tok_per_s']:.1f} tok/s; "
              f"greedy tokens identical for {same}/{len(toks_c)} requests; first "
              f"decode step logits max rel diff {rel:.3g}", flush=True)
        if plan in ("w2a2", "w2a8_bs") and (same != len(toks_c) or rel != 0.0):
            fail(f"{plan}: kernel and plain paths differ (tokens identical for "
                 f"{same}/{len(toks_c)} requests, first-step logits by {rel})")
        if plan == "w2a16" and rel > TOL_LOGITS:
            fail(f"w2a16 first-step logits differ by {rel} > {TOL_LOGITS}")

        # 6: GEMM kernels on, attention on its plain version
        cap_a: dict = {}
        reset_counts(wrappers)
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
    del res_k, res_c, res_p, res_a, cap_k, cap_c, cap_p, cap_a

    # 8: planted long-context decode, qwen1.5-0.5b under w2a8_bs
    mark("8 long")
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
        print(f"[8 long] ctx {ctx}: kv_splits auto picks "
              f"{auto_kv_splits(LC_SLOTS, cfg.n_kv_heads, ctx + 4 * LC_BLOCK)} at this "
              "engine's shapes", flush=True)
        merge_ms = split["profile"]["attention_device_ms_per_step"]["merge_kernel"]
        print(f"[8 long] ctx {ctx}: merge_kernel "
              f"{'ran' if merge_ms > 0 else 'did not run'} in the kv_splits "
              f"{LC_SPLITS} profile ({merge_ms:.3f} ms/step)", flush=True)
        if merge_ms > 0:
            fail(f"ctx {ctx}: merge_kernel ran at kv_splits {LC_SPLITS}, which "
                 "one cluster a head merges on chip")
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
    mark("9 codeqwen")
    args = serve.build_parser().parse_args(
        ["--arch", "codeqwen1.5-7b", "--paged", "--plan", "w2a8_bs", "--device",
         "cuda"])
    cfg, qparams = serve.prepare(args)
    cap_k = {}
    reset_counts(wrappers)
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
    reset_counts(wrappers)
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
    mark("10 moe")
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
        cfg = dataclasses.replace(serve.config_for(args)[0], n_layers=MOE_ENGINE_LAYERS)
        qparams = serve.pack_params(cfg, args, f"plan '{plan}'")
        pack_s = time.perf_counter() - t0
        packed_gb = torch.cuda.memory_allocated() / 1e9 - base_gb
        pack_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n, E = cfg.n_layers, cfg.moe.n_experts
        cap_k = {}
        reset_counts(wrappers)
        res_k = run_engine(torch, serve, cfg, qparams, args, cap_k)
        launches = {name: w.launches for name, w in wrappers.items()}
        m = res_k["metrics"]
        forwards = m["decode_steps"] + m["prefill_chunks"]
        print(f"[10 moe] {cfg.name} {plan} ({n} of 48 layers, {E} experts top-"
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
        reset_counts(wrappers)
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
    mark("11 fixed")
    fixed = {}
    for arch, plan, op in FIXED_RUNS:
        args = serve.build_parser().parse_args(
            ["--arch", arch, "--plan", plan, "--device", "cuda"])
        cfg, desc = serve.config_for(args)
        full = cfg.n_layers
        cfg = dataclasses.replace(cfg, n_layers=FIXED_LAYERS)   # the first layers
        qparams = serve.pack_params(cfg, args, desc)
        n, B, gen = cfg.n_layers, args.batch, args.gen
        what = f"{arch} {plan} ({cfg.kv_cache_dtype} cache, {n} of {full} layers)"
        call_errs: list = []
        reset_counts(wrappers)
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
        reset_counts(wrappers)
        res_p = fixed_run(torch, serve, cfg_p, qparams, args)
        if any(gemms[name].launches for name in gemms):
            fail(f"fixed {what}: the plain-GEMM run launched a GEMM kernel")
        same = int((res_k["tokens"] == res_p["tokens"]).all(axis=1).sum())
        rel = rel_diff(res_k["first_logits"], res_p["first_logits"])
        reset_counts(wrappers)
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
    mark("12 moe g64")
    args = serve.build_parser().parse_args(
        ["--arch", "moonshot-v1-16b-a3b", "--plan", "w2a2g64", "--device", "cuda"])
    cfg, desc = serve.config_for(args)
    cfg = dataclasses.replace(cfg, n_layers=MOE_FIXED_LAYERS)   # the first layers
    qparams = serve.pack_params(cfg, args, desc)
    n, B, gen = cfg.n_layers, args.batch, args.gen
    reset_counts(wrappers)
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
    reset_counts(wrappers)
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
    mark("13 tp")
    from repro_torch.configs import get_config
    cfg = get_config("qwen1.5-0.5b")
    tp = {}
    for plan in ("w2a8_bs", "w2a8_bs_g64"):
        argv = ["--arch", "qwen1.5-0.5b", "--paged", "--plan", plan, "--device",
                "cuda"]
        if plan == "w2a8_bs_g64":     # its own single-rank run: cut both
            argv += ["--requests", str(TP_G64_CUT), "--gen", str(TP_G64_GEN)]
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

    # 14: the paged engine's serving features
    mark("14 features")
    results["features"] = phase_features(torch, serve, wrappers, gemms, smi,
                                         expect_launches)
    gc.collect()
    torch.cuda.empty_cache()

    # 15 and 16: the local-attention models at full width and depth
    for tag, (arch, plans, fixed_b, fixed_p) in zip(("15 gemma3", "16 danube"),
                                                     LOCAL_MODELS):
        mark(tag)
        results[arch] = phase_local_model(torch, serve, wrappers, gemms, smi,
                                          expect_launches, tag, arch, plans, fixed_b,
                                          fixed_p)
    gc.collect()
    torch.cuda.empty_cache()

    # 17: the paper's CNN through lut_gemm; 18: the quantization front end
    mark("17 cnn")
    results["cnn"] = phase_cnn(torch, dev, smi, rows)
    mark("18 quant")
    results["quant"] = phase_quant_front(torch, dev, serve, wrappers, gemms, smi,
                                         expect_launches, rows)
    # 19 and 20: the recurrent models at full width and depth
    for tag, arch, plans, fixed_plan, fixed_b, fixed_p in RECURRENT_MODELS:
        mark(tag)
        results[arch] = phase_recurrent_model(torch, serve, wrappers, gemms, smi,
                                              expect_launches, tag, arch, plans,
                                              fixed_plan, fixed_b, fixed_p)
    mark("done")
    names = list(starts)
    print("[phases] seconds: " + ", ".join(
        f"{a} {starts[b] - starts[a]:.1f}" for a, b in zip(names, names[1:])), flush=True)

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
                       and r["label"] == "moonshot decode"
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
