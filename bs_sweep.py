#!/usr/bin/env python3
"""Times of the two bit-sliced LUT GEMM kernels on one card, and a sweep of
their tiling.

  python3 bs_sweep.py                   # from the root of a checkout, one CUDA card
  python3 bs_sweep.py --src OTHER/src   # another checkout's kernels (its own tiling)
  python3 bs_sweep.py --no-sweep        # the chosen tiling only

Times lut_gemm_bs_fused (bf16 x, dynamic scales, w2 per channel and g64)
and lut_gemm_bitsliced (int8 codes, w2 per channel and g64) at
qwen1.5-0.5b's projection shapes (K x N = 1024x1024, 1024x2816, 2816x1024;
M 1, 4, 32 and the fixed loop's prefill, 4 prompts of 32 tokens: M 128),
the K slices tp=2 gives the two-step kernel (512x1024, 1408x1024) and
codeqwen1.5-7b's shapes (4096x4096, 4096x13440, 13440x4096; M 1, 4, 128;
and 13440x4096 at M 4 in groups of 4, which takes several rounds),
each beside torch.matmul of bf16 activations against the pre-dequantized
bf16 weight (the yardstick chip_smoke.py uses) and the byte bound. Every
kernel output is held against its plain version (err). Times come from
chip_smoke.graph_ms (CUDA graphs, CUDA events). Where the kernels take a
tiling (kernels/lut_gemm_bitsliced.py::bs_partition), each line prints it
with its blocks and the clusters the card holds at once, and, unless
--no-sweep, every (NT, C) follows (per channel: M 4 and 32 on qwen's and
the tp=2 shapes, M 4 on codeqwen's; grouped: codeqwen's 4096x13440 in
groups of 64 at M 4 and 128, 13440x4096 in groups of 64 at M 128 and in
groups of 4 at M 4), the chosen one marked. Exits nonzero without a card.

--src imports that checkout's repro_torch, so its kernels build into that
checkout's build/ directory (kernels/build.py), not this one's: to time
the parent beside the change, unpack the parent into a directory that
.gitignore lists and run the script once with --src on each, in turns.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

QWEN = ((1024, 1024), (1024, 2816), (2816, 1024))
TP_SLICES = ((512, 1024), (1408, 1024))
CODEQWEN = ((4096, 4096), (4096, 13440), (13440, 4096))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bs_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import HBM_BYTES_PER_S, graph_ms
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import packing, quant
    from repro_torch.kernels import lut_gemm_bitsliced as BS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | {BS.__file__}", flush=True)
    tiled = hasattr(BS, "bs_partition")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def one(op, M, K, N, G, mark="", **tile):
        """Time op at (M, K, N, G) on bs_partition's tiling (``tile``:
        its ranks and cols)."""
        w_idx = torch.randint(0, 4, (N, K), generator=gen, device=dev, dtype=torch.uint8)
        planes = packing.pack_bitplanes_signed(w_idx, 2)
        sc = torch.rand((N,) if G is None else (N, K // G), generator=gen,
                        device=dev) * 0.02 + 0.01
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        kw = dict(w_bits=2, group_size=G, **tile)
        if op == "lut_gemm_bs_fused":
            a, fn, want_fn = x, BS.lut_gemm_bs_fused_cuda, BS.lut_gemm_bs_fused_plain
            args_ = (x, planes, sc, None)
            operand_bytes = x.numel() * 2
        else:
            a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            fn, want_fn = BS.lut_gemm_bitsliced_cuda, BS.lut_gemm_bitsliced_plain
            args_ = (a, planes, sc if G else None)
            operand_bytes = a.numel()
        got = fn(*args_, **kw)
        torch.cuda.synchronize()
        want = want_fn(*args_, w_bits=2, group_size=G)
        err = (got - want).abs().max().item()
        ms = graph_ms(torch, lambda: fn(*args_, **kw))
        w_deq = ((w_idx.float() - 2) * (sc[:, None] if G is None else
                                        quant.expand_group_scales(sc, G))).to(torch.bfloat16)
        xb = a.to(torch.bfloat16)
        lib = graph_ms(torch, lambda: torch.matmul(xb, w_deq.T))
        n_bytes = planes.numel() + sc.numel() * 4 + operand_bytes + M * N * 4
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        text = ""
        if tiled:
            (MT, NT, C, kpr), active = BS.bs_active_clusters(op, M, N, K, 2, G, **tile)
            blocks = -(-N // NT) * -(-M // MT) * C
            text = (f" MT={MT} NT={NT:<3d} C={C} K/rank={kpr:<5d} "
                    f"rounds={BS.bs_rounds(K, C, kpr)} blocks={blocks:<4d} "
                    f"active={active:<4d}")
        print(f"  {op:18s} M={M:<3d} K={K:<5d} N={N:<5d} {'g' + str(G) if G else 'ch':4s}"
              f"{text} kernel={ms * 1e3:8.2f}us matmul={lib * 1e3:8.2f}us "
              f"bound={bound * 1e3:6.2f}us err={err:.3g}{mark}", flush=True)
        del w_deq, planes, w_idx

    print("[times at the chosen tiling]", flush=True)
    for op in ("lut_gemm_bs_fused", "lut_gemm_bitsliced"):
        shapes = [(M, K, N) for K, N in QWEN for M in (1, 4, 32, 128)]
        if op == "lut_gemm_bitsliced":
            shapes += [(M, K, N) for K, N in TP_SLICES for M in (1, 4, 32)]
        shapes += [(M, K, N) for K, N in CODEQWEN for M in (1, 4, 128)]
        for M, K, N in shapes:
            for G in (None, 64):
                one(op, M, K, N, G)
        one(op, 4, 13440, 4096, 4)          # small groups over a long K
    if tiled and not args.no_sweep:
        print("[sweep: every (NT, C)]", flush=True)
        shapes = ([(M, K, N, None) for K, N in QWEN + TP_SLICES for M in (4, 32)]
                  + [(4, K, N, None) for K, N in CODEQWEN]
                  + [(M, 4096, 13440, 64) for M in (4, 128)]
                  + [(128, 13440, 4096, 64), (4, 13440, 4096, 4)])
        for op in ("lut_gemm_bs_fused", "lut_gemm_bitsliced"):
            for M, K, N, G in shapes:
                pick = BS.bs_partition(M, N, K, G)
                seen = set()
                for NT in BS.BS_COL_TILES:
                    for C in range(1, BS.BS_MAX_CLUSTER + 1):
                        try:
                            part = BS.bs_partition(M, N, K, G, ranks=C, cols=NT)
                        except ValueError:      # more ranks than K has segments
                            continue
                        if part in seen:
                            continue
                        seen.add(part)
                        one(op, M, K, N, G, "  <- bs_partition" if part == pick else "",
                            ranks=C, cols=NT)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
