#!/usr/bin/env python3
"""Sweeps of the decode-attention kernels on one card.

  python3 attn_sweep.py                     # every sweep, one CUDA card
  python3 attn_sweep.py --only split        # one of clusters, split, rows
  python3 attn_sweep.py --src OTHER/src --only rows   # another checkout's kernels

clusters: kv_cache_attention and the single-pass paged_attention
(src/repro_torch/csrc, built as chip_smoke.py builds them) at qwen1.5-0.5b's
long-context shapes (KV 16, hd 64, int8, bf16 q; B 2 and 4 at 32k, B 2 at
8k, the pool in 512-row blocks) for every cluster size C from 1 to 16
that cuts the rows into whole tiles (and whole blocks), each through its C
entry point with that C. Each line gives C, the blocks, the clusters the
card holds at once (cudaOccupancyMaxActiveClusters), the kernel's time
(chip_smoke.graph_ms) and a mark on the C that
kernels/paged_attention.py::cluster_ranks chooses. The sweep is what the
rule's BLOCKS_PER_SM rests on: a launch whose clusters do not all fit at
once runs a second wave.

split: paged_attention_splitkv at every kv_splits from 1 to 32 (each
number of chunks once) at the long-context decode of chip_smoke.py's
phase 8 (8k, 16k and 32k rows, tables of ctx / 512 + 4 entries, full
lengths)
for the served models' attention shapes (SPLIT_SHAPES: qwen1.5-0.5b at B
1, 2 and 4, codeqwen1.5-7b and moonshot-v1-16b-a3b at B 1 and 2, and a
GQA shape), each line with its clusters a head (K) and ranks a cluster (C)
from split_clusters, its blocks and the clusters resident at once, beside
the single pass with cluster_ranks' C; the fastest route of each shape is
marked. Serving/engine.py's kv_splits "auto" rests on this sweep.

rows: paged_attention and paged_attention_splitkv at the shapes of
PERF.md's kernel table (qwen serve with kv_splits 2, and 8k and 32k with
kv_splits 8), the outputs held against the plain versions. It takes only
the public wrappers, so --src can time a parent checkout's kernels, which
build into that checkout's build/ directory: unpack the parent into a
directory that .gitignore lists and run the script with --src on each, in
turns.

Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


# (label, B, KV, G, hd, bits, bs, lengths, nb, kv_splits): PERF.md's table
ROWS = (
    ("qwen serve", 4, 16, 1, 64, 8, 16, (4, 23, 48, 64), 4, 1),
    ("qwen serve", 4, 16, 1, 64, 8, 16, (4, 23, 48, 64), 4, 2),
    ("long 8k", 2, 16, 1, 64, 8, 512, (8192, 8192), 20, 1),
    ("long 8k", 2, 16, 1, 64, 8, 512, (8192, 8192), 20, 8),
    ("long 32k", 2, 16, 1, 64, 8, 512, (32768, 32768), 68, 1),
    ("long 32k", 2, 16, 1, 64, 8, 512, (32768, 32768), 68, 8),
)


# (label, B, KV, G, hd, bits) of the split sweep
SPLIT_SHAPES = (
    ("qwen", 1, 16, 1, 64, 8), ("qwen", 2, 16, 1, 64, 8), ("qwen", 4, 16, 1, 64, 8),
    ("codeqwen", 1, 32, 1, 128, 4), ("codeqwen", 2, 32, 1, 128, 4),
    ("moonshot", 1, 16, 1, 128, 8), ("moonshot", 2, 16, 1, 128, 8),
    ("gqa", 1, 8, 4, 128, 8),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--only", choices=("clusters", "split", "rows"), default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attn_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import TOL_ATTN, attention_operands, graph_ms
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import paged_attention as PA

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | {PA.__file__}", flush=True)
    dev = torch.device("cuda")
    if args.only in (None, "rows"):
        rows(torch, dev, PA, graph_ms, attention_operands, TOL_ATTN)
    if args.only in (None, "split"):
        split(torch, dev, PA, graph_ms, attention_operands)
    if args.only in (None, "clusters"):
        clusters(torch, dev, graph_ms)
    return 0


def rows(torch, dev, PA, graph_ms, attention_operands, tol) -> None:
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, B, KV, G, hd, bits, bs, lengths, nb, ks in ROWS:
        ops = attention_operands(torch, dev, gen, B=B, KV=KV, G=G, hd=hd, bits=bits,
                                 bs=bs, lengths=lengths, nb=nb, q_dtype=torch.bfloat16)
        if ks == 1:
            name = "paged_attention"
            kern = lambda: PA.paged_attention_cuda(*ops, bits=bits)  # noqa: E731
            want = PA.paged_attention_plain(*ops, bits=bits)
        else:
            name = "paged_attention_splitkv"
            kern = lambda: PA.paged_attention_splitkv_cuda(  # noqa: E731
                *ops, bits=bits, kv_splits=ks)
            want = PA.paged_attention_splitkv_plain(*ops, bits=bits, kv_splits=ks)
        err = (kern() - want).abs().max().item() / want.abs().max().item()
        if not err <= tol:
            raise SystemExit(f"{name} {label} disagrees with its plain version: {err}")
        print(f"  rows {name:23s} {label:10s} splits={ks} us={graph_ms(torch, kern) * 1e3:.3f}"
              f" err={err:.3g}", flush=True)


def split(torch, dev, PA, graph_ms, attention_operands) -> None:
    bs = 512
    gen = torch.Generator(device=dev).manual_seed(2)
    for ctx in (8192, 16384, 32768):
        for label, B, KV, G, hd, bits in SPLIT_SHAPES:
            nb = ctx // bs + 4
            ops = attention_operands(torch, dev, gen, B=B, KV=KV, G=G, hd=hd, bits=bits,
                                     bs=bs, lengths=(ctx,) * B, nb=nb,
                                     q_dtype=torch.bfloat16)
            print(f"split {label} B={B} KV={KV} G={G} hd={hd} int{bits} ctx={ctx}, block "
                  f"{bs}, {nb} table entries", flush=True)
            C, active = PA.paged_attention_active_clusters(B, KV, G, hd, bs, nb, bits,
                                                           torch.bfloat16)
            times = [("single pass", graph_ms(
                torch, lambda: PA.paged_attention_cuda(*ops, bits=bits)) * 1e3)]
            print(f"  single pass C={C:2d} blocks={B * KV * C:4d} "
                  f"clusters_at_once={active:4d} us={times[0][1]:.3f}  <- cluster_ranks",
                  flush=True)
            seen = set()
            for ks in range(1, 33):
                ns = PA.split_partition(nb, ks)[0]
                if ns in seen:
                    continue
                seen.add(ns)
                K, C, active = PA.paged_attention_splitkv_active_clusters(
                    B, KV, G, hd, bs, nb, bits, torch.bfloat16, ks)
                us = graph_ms(torch, lambda: PA.paged_attention_splitkv_cuda(
                    *ops, bits=bits, kv_splits=ks)) * 1e3
                times.append((f"kv_splits {ks}", us))
                print(f"  split kv_splits={ks:2d} K={K} C={C:2d} blocks={B * KV * K * C:4d} "
                      f"clusters_at_once={active:4d} us={us:.3f}", flush=True)
            best = min(times, key=lambda t: t[1])
            print(f"  fastest {label} B={B} ctx={ctx}: {best[0]} ({best[1]:.3f} us; "
                  f"single pass {times[0][1]:.3f} us)", flush=True)
            del ops


def clusters(torch, dev, graph_ms) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import KERNEL_TILE, cluster_ranks

    gen = torch.Generator(device=dev).manual_seed(0)
    KV, G, hd, bits = 16, 1, 64, 8

    def codes(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.045 + 0.005

    def sweep(name, extent, B, unit, launch, active):
        """Every C whose chunk of whole tiles and units leaves no rank empty."""
        pick = cluster_ranks(extent, B, KV, G, unit=unit)[0]
        step = max(KERNEL_TILE, unit)
        seen = set()
        for want in range(1, 17):
            rows = -(-(-(-extent // want)) // step) * step
            C = -(-extent // rows)
            if C in seen:
                continue
            seen.add(C)
            us = graph_ms(torch, lambda: launch(C, rows)) * 1e3
            print(f"  {name} C={C:2d} blocks={B * KV * C:4d} "
                  f"clusters_at_once={active(C, rows):4d} us={us:.3f}"
                  f"{'  <- cluster_ranks' if C == pick else ''}", flush=True)

    lib = build.library("kv_cache_attention")
    for B, S in ((2, 8192), (2, 32768), (4, 32768)):
        shape = (B, S, KV, hd)
        q = torch.randn((B, KV, G, hd), generator=gen, device=dev).bfloat16()
        k, v, ks, vs = codes(shape), codes(shape), scales(shape[:3]), scales(shape[:3])
        lens = torch.full((B,), S, dtype=torch.int64, device=dev)
        out = torch.empty((B, KV, G, hd), device=dev)
        ops = [t.data_ptr() for t in (q, k, ks, v, vs, lens, out)]

        def launch(C, rows):
            build.check(lib.kv_cache_attention_launch(
                *ops, B, S, KV, G, hd, bits, 1, C, rows,
                torch.cuda.current_stream().cuda_stream), "kv_cache_attention")

        def active(C, rows):
            return lib.kv_cache_attention_active_clusters(B, S, KV, G, hd, bits, 1, C,
                                                          rows)

        print(f"kv_cache_attention B={B} S={S}", flush=True)
        sweep("kv_cache_attention", S, B, 1, launch, active)
        del k, v, ks, vs

    lib = build.library("paged_attention")
    bs, nb = 512, 68
    for B in (2, 4):
        n_blocks = 1 + B * (32768 // bs)
        shape = (n_blocks, bs, KV, hd)
        q = torch.randn((B, KV, G, hd), generator=gen, device=dev).bfloat16()
        k, v, ks, vs = codes(shape), codes(shape), scales(shape[:3]), scales(shape[:3])
        tables = torch.zeros((B, nb), dtype=torch.int64, device=dev)
        tables[:, :32768 // bs] = 1 + torch.randperm(n_blocks - 1, generator=gen,
                                                     device=dev).reshape(B, -1)
        lens = torch.full((B,), 32768, dtype=torch.int64, device=dev)
        out = torch.empty((B, KV, G, hd), device=dev)
        ops = [t.data_ptr() for t in (q, k, ks, v, vs, tables, lens, out)]

        def launch(C, rows):
            build.check(lib.paged_attention_launch(
                *ops, B, KV, G, hd, bs, nb, bits, 1, C, rows // bs, 0,
                torch.cuda.current_stream().cuda_stream), "paged_attention")

        def active(C, rows):
            return lib.paged_attention_active_clusters(B, KV, G, hd, bs, nb, bits, 1, C,
                                                       rows // bs, 0)

        print(f"paged_attention B={B} 32k, block {bs}, {nb} table entries", flush=True)
        sweep("paged_attention", nb * bs, B, bs, launch, active)
        del k, v, ks, vs


if __name__ == "__main__":
    raise SystemExit(main())
