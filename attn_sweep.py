#!/usr/bin/env python3
"""Cluster-size sweep of the single-pass decode-attention kernels on one card.

  python3 attn_sweep.py            # from the root of a checkout, one CUDA card

Times kv_cache_attention and the single-pass paged_attention
(src/repro_torch/csrc, built as chip_smoke.py builds them) at qwen1.5-0.5b's
long-context shapes (KV 16, hd 64, int8, bf16 q; B 2 and 4 at 32k, B 2 at
8k, the pool in 512-row blocks) for every cluster size C from 1 to 16
that cuts the rows into whole tiles (and whole blocks), each through its C
entry point with that C. Each line gives C, the blocks, the clusters the
card holds at once (cudaOccupancyMaxActiveClusters), the kernel's time
(chip_smoke.graph_ms) and a mark on the C that
kernels/paged_attention.py::cluster_ranks chooses. The sweep is what the
rule's BLOCKS_PER_SM rests on: a launch whose clusters do not all fit at
once runs a second wave. Exits nonzero without a card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attn_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import graph_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import KERNEL_TILE, cluster_ranks

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
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
                *ops, B, KV, G, hd, bs, nb, bits, 1, C, rows // bs,
                torch.cuda.current_stream().cuda_stream), "paged_attention")

        def active(C, rows):
            return lib.paged_attention_active_clusters(B, KV, G, hd, bs, nb, bits, 1, C,
                                                       rows // bs)

        print(f"paged_attention B={B} 32k, block {bs}, {nb} table entries", flush=True)
        sweep("paged_attention", nb * bs, B, bs, launch, active)
        del k, v, ks, vs
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
