#!/usr/bin/env python3
"""Times of the packed-weight GEMM kernels on one card, and a sweep of
their tiling.

  python3 bs_sweep.py                   # from the root of a checkout, one CUDA card
  python3 bs_sweep.py --src OTHER/src   # another checkout's kernels (its own tiling)
  python3 bs_sweep.py --no-sweep        # the chosen tiling only
  python3 bs_sweep.py --only dense      # lut_gemm and dequant_matmul only (--only bs:
                                        # the bit-sliced pair only)
  python3 bs_sweep.py --only expert     # expert_dequant_matmul and expert_lut_gemm only

lut_gemm (w2a2, w2a2 in groups of 64, w4a8) and dequant_matmul (bf16
activations; w2, w2 in groups of 128, w4) are timed at qwen1.5-0.5b's
projection shapes, M 1, 4, 32 and 128, beside torch.matmul and the byte
bound, each line with its tiling (kernels/lut_gemm.py::dense_partition:
MT, NT, C, the window, the rounds, blocks, clusters resident at once);
dequant_matmul's lines also time its plain version (tied to the kernel's
summation order, so its cost is the tie's); unless --no-sweep, every
(NT, C) follows for each of them at those shapes, the chosen one marked.

--only expert times expert_dequant_matmul (bf16 rows; w2, w2 in groups of
64, w4) and expert_lut_gemm (w2a2, w2a2 in groups of 64) at
moonshot-v1-16b-a3b's expert shapes (chip_smoke.EXPERT_SHAPES: E 64, M 4
and 16), every expert filled, beside torch.bmm of bf16 against the
pre-dequantized weight, the byte bound and (dequant) the tied plain
version's time, each line with its tiling (kernels/lut_gemm.py::
expert_partition); then the decode shape with 24 of the 64 experts
flagged active (chip_smoke.EXPERT_ACTIVE, drawn from a seed; the bound
counts the active experts' bytes; a parent without the flag computes all
64); unless --no-sweep, every (NT, C) at EXPERT_SHAPES follows.

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
    ap.add_argument("--only", choices=("dense", "bs", "expert"), default=None,
                    help="time one family of kernels only")
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
    if args.only in (None, "expert"):
        expert(torch, dev, not args.no_sweep)
    if args.only in (None, "dense"):
        dense(torch, dev, graph_ms, HBM_BYTES_PER_S, not args.no_sweep)
    if args.only in ("dense", "expert"):
        return 0

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


def dense(torch, dev, graph_ms, hbm_bytes_per_s, sweep: bool) -> None:
    """lut_gemm and dequant_matmul at qwen's shapes (and, with ``sweep``,
    every (NT, C)), each beside torch.matmul and the byte bound."""
    from repro_torch.core import packing, quant
    from repro_torch.core.lut import product_lut
    from repro_torch.kernels import lut_dequant_matmul as DQ
    from repro_torch.kernels import lut_gemm as LG

    tiled = hasattr(LG, "dense_partition")
    gen = torch.Generator(device=dev).manual_seed(0)

    def one(op, M, K, N, wb, ab, G, mark="", **tile):
        """Time op (lut_gemm w{wb}a{ab}, or dequant_matmul w{wb} with bf16
        rows when ab is 16) at (M, K, N, G) on dense_partition's tiling
        (``tile``: its ranks and cols)."""
        w_idx = torch.randint(0, 2 ** wb, (N, K), generator=gen, device=dev,
                              dtype=torch.uint8)
        wp = packing.pack(w_idx, wb)
        levels = quant.uniform_codebook(wb, device=dev).levels
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        if op == "lut_gemm":
            a_idx = torch.randint(0, 2 ** ab, (M, K), generator=gen, device=dev,
                                  dtype=torch.uint8)
            ap = packing.pack(a_idx, ab)
            lut = product_lut(quant.uniform_codebook(wb, device=dev),
                              quant.uniform_codebook(ab, device=dev)).table
            sc = None if G is None else (
                torch.rand((N, K // G), generator=gen, device=dev) * 0.1 + 0.01)
            args_ = (ap, wp, lut, sc)
            kw = dict(w_bits=wb, a_bits=ab, group_size=G)
            fn, want_fn = LG.lut_gemm_cuda, LG.lut_gemm_plain
            w_deq = levels[w_idx.long()].to(torch.bfloat16)
            n_bytes = ap.numel() + wp.numel() + lut.numel() * 4 + (
                0 if sc is None else sc.numel() * 4) + M * N * 4
        else:
            sc = torch.rand((N,) if G is None else (N, K // G), generator=gen,
                            device=dev) * 0.1 + 0.01
            args_ = (x, wp, levels, sc)
            kw = dict(bits=wb, group_size=G)
            fn, want_fn = DQ.dequant_matmul_cuda, DQ.dequant_matmul_plain
            w_deq = (levels[w_idx.long()] * (sc[:, None] if G is None else
                                             quant.expand_group_scales(sc, G))
                     ).to(torch.bfloat16)
            n_bytes = x.numel() * 2 + wp.numel() + levels.numel() * 4 + \
                sc.numel() * 4 + M * N * 4
        got = fn(*args_, **kw, **tile)
        torch.cuda.synchronize()
        # the dequant plain version replays the kernel's tiling
        want = want_fn(*args_, **kw, **(tile if op == "dequant_matmul" else {}))
        err = (got - want).abs().max().item()
        ms = graph_ms(torch, lambda: fn(*args_, **kw, **tile))
        lib = graph_ms(torch, lambda: torch.matmul(x, w_deq.T))
        bound = n_bytes / hbm_bytes_per_s * 1e3
        plain = ""
        if op == "dequant_matmul" and not tile:   # the tied replay's own cost
            p_ms = graph_ms(torch, lambda: want_fn(*args_, **kw), reps=3, replays=3)
            plain = f" plain={p_ms * 1e3:9.2f}us"
        text = ""
        if tiled:
            (MT, NT, C, kpr), active = LG.dense_active_clusters(
                op, M, N, K, wb, ab, G, **tile)
            blocks = -(-N // NT) * -(-M // MT) * C
            text = (f" MT={MT} NT={NT:<3d} C={C} K/rank={kpr:<5d} "
                    f"rounds={LG.dense_rounds(K, C, kpr)} blocks={blocks:<4d} "
                    f"active={active:<4d}")
        cfg = (f"w{wb}a{ab}" if op == "lut_gemm" else f"w{wb}a16") + (f"g{G}" if G else "")
        print(f"  {op:15s} {cfg:9s} M={M:<3d} K={K:<5d} N={N:<5d}{text} "
              f"kernel={ms * 1e3:8.2f}us matmul={lib * 1e3:8.2f}us "
              f"bound={bound * 1e3:6.2f}us{plain} err={err:.3g}{mark}", flush=True)
        del w_deq, wp, w_idx

    cases = [("lut_gemm", 2, 2, None), ("lut_gemm", 2, 2, 64), ("lut_gemm", 4, 8, None),
             ("dequant_matmul", 2, 16, None), ("dequant_matmul", 2, 16, 128),
             ("dequant_matmul", 4, 16, None)]
    print("[dense: times at the chosen tiling]", flush=True)
    for op, wb, ab, G in cases:
        for K, N in QWEN:
            for M in (1, 4, 32, 128):
                one(op, M, K, N, wb, ab, G)
    if not (tiled and sweep):
        return
    print("[dense sweep: every (NT, C)]", flush=True)
    for op, wb, ab, G in cases:
        for K, N in QWEN:
            for M in (1, 4, 32, 128):
                pick = LG.dense_partition(M, N, K, wb, ab, G)
                seen = set()
                for NT in LG.DENSE_COL_TILES:
                    for C in range(1, LG.DENSE_MAX_CLUSTER + 1):
                        try:
                            part = LG.dense_partition(M, N, K, wb, ab, G, ranks=C, cols=NT)
                        except ValueError:      # more ranks than K has windows
                            continue
                        if part in seen:
                            continue
                        seen.add(part)
                        one(op, M, K, N, wb, ab, G,
                            "  <- dense_partition" if part == pick else "",
                            ranks=C, cols=NT)


def expert(torch, dev, sweep: bool) -> None:
    """expert_dequant_matmul and expert_lut_gemm at EXPERT_SHAPES (and,
    with ``sweep``, every (NT, C)), each beside torch.bmm, the byte bound
    and (dequant) the tied plain version; then the decode shape with
    EXPERT_ACTIVE experts flagged."""
    from chip_smoke import EXPERT_ACTIVE, EXPERT_SHAPES, HBM_BYTES_PER_S, graph_ms
    from repro_torch.core import packing, quant
    from repro_torch.core.lut import product_lut
    from repro_torch.kernels import expert_gemm as EG
    from repro_torch.kernels import lut_gemm as LG

    tiled = hasattr(LG, "expert_partition")
    gen = torch.Generator(device=dev).manual_seed(0)

    def one(op, E, M, K, N, bits, G, n_active=None, mark="", plain=False, **tile):
        """Time op at (E, M, K, N, G) on expert_partition's tiling
        (``tile``: its ranks and cols), with ``n_active`` experts flagged
        where given."""
        w_idx = torch.randint(0, 2 ** bits, (E, N, K), generator=gen, device=dev,
                              dtype=torch.uint8)
        wp = packing.pack(w_idx, bits)
        levels = quant.uniform_codebook(bits, device=dev).levels
        sc_shape = (E, N) if G is None else (E, N, K // G)
        kw, on = {}, torch.ones(E, dtype=torch.bool, device=dev)
        if n_active is not None:
            on = torch.zeros(E, dtype=torch.bool, device=dev)
            on[torch.randperm(E, generator=gen, device=dev)[:n_active]] = True
            if tiled:
                kw["active"] = on
        if op == "expert_dequant_matmul":
            x = torch.randn((E, M, K), generator=gen, device=dev).to(torch.bfloat16)
            x[~on] = 0
            sc = torch.rand(sc_shape, generator=gen, device=dev) * 0.1 + 0.01
            args_ = (x, wp, levels, sc)
            kw.update(bits=bits, group_size=G)
            w_scale = sc[..., None] if G is None else quant.expand_group_scales(sc, G)
            xb, in_bytes = x, x[on].numel() * 2 + levels.numel() * 4 + sc[on].numel() * 4
        else:
            a_idx = torch.randint(0, 2 ** bits, (E, M, K), generator=gen, device=dev,
                                  dtype=torch.uint8)
            a_idx[~on] = 2 ** (bits - 1)              # the code of 0.0
            ap = packing.pack(a_idx, bits)
            sc = None if G is None else (
                torch.rand(sc_shape, generator=gen, device=dev) * 0.1 + 0.01)
            args_ = (ap, wp, product_lut(levels, levels).table, sc)
            kw.update(w_bits=bits, a_bits=bits, group_size=G)
            w_scale = 1.0 if G is None else quant.expand_group_scales(sc, G)
            xb = levels[a_idx.long()].to(torch.bfloat16)
            in_bytes = ap[on].numel() + 16 * 4 + (0 if sc is None else sc[on].numel() * 4)
        fn, want_fn = getattr(EG, f"{op}_cuda"), getattr(EG, f"{op}_plain")
        got = fn(*args_, **kw, **tile)
        torch.cuda.synchronize()
        # the dequant plain version replays the kernel's tiling
        want = want_fn(*args_, **kw, **(tile if op == "expert_dequant_matmul" else {}))
        err = (got - want).abs().max().item()
        ms = graph_ms(torch, lambda: fn(*args_, **kw, **tile))
        wdq = (levels[w_idx.long()] * w_scale).to(torch.bfloat16).transpose(1, 2).contiguous()
        del w_idx
        lib = graph_ms(torch, lambda: torch.bmm(xb, wdq))
        del wdq
        n_on = int(on.sum().item())
        bound = (wp[on].numel() + in_bytes + E * M * N * 4) / HBM_BYTES_PER_S * 1e3
        text = ""
        if plain:                                     # the tied replay's own cost
            p_ms = graph_ms(torch, lambda: want_fn(*args_, **kw), reps=2, replays=2)
            text = f" plain={p_ms * 1e3:9.2f}us"
        if tiled:
            ab = 16 if op == "expert_dequant_matmul" else bits
            (MT, NT, C, kpr), active = EG.expert_active_clusters(
                op, E, M, N, K, bits, ab, G, **tile)
            blocks = E * -(-N // NT) * -(-M // MT) * C
            text = (f" MT={MT} NT={NT:<3d} C={C} K/rank={kpr:<5d} "
                    f"rounds={LG.dense_rounds(K, C, kpr)} blocks={blocks:<5d} "
                    f"active={active:<4d}") + text
        cfg = (f"w{bits}a16" if op == "expert_dequant_matmul" else f"w{bits}a{bits}") + (
            f"g{G}" if G else "")
        experts = f"{n_on}/{E}" if n_active is not None else f"{E}"
        print(f"  {op:21s} {cfg:8s} E={experts:<5s} M={M:<3d} K={K:<5d} N={N:<5d}{text} "
              f"kernel={ms * 1e3:8.2f}us bmm={lib * 1e3:8.2f}us bound={bound * 1e3:6.2f}us "
              f"err={err:.3g}{mark}", flush=True)
        del wp

    cases = [("expert_dequant_matmul", 2, None), ("expert_dequant_matmul", 2, 64),
             ("expert_dequant_matmul", 4, None), ("expert_lut_gemm", 2, None),
             ("expert_lut_gemm", 2, 64)]
    print("[expert: times at the chosen tiling]", flush=True)
    for op, bits, G in cases:
        for E, M, K, N in EXPERT_SHAPES:
            one(op, E, M, K, N, bits, G, plain=op == "expert_dequant_matmul" and G is None)
    E, M, K, N = EXPERT_SHAPES[0]
    for op, bits, G in cases:
        one(op, E, M, K, N, bits, G, n_active=EXPERT_ACTIVE)
    if not (tiled and sweep):
        return
    print("[expert sweep: every (NT, C)]", flush=True)
    for op, bits, G in cases:
        ab = 16 if op == "expert_dequant_matmul" else bits
        for E, M, K, N in EXPERT_SHAPES:
            pick = LG.expert_partition(E, M, N, K, bits, ab, G)
            seen = set()
            for NT in LG.DENSE_COL_TILES:
                for C in range(1, LG.DENSE_MAX_CLUSTER + 1):
                    try:
                        part = LG.expert_partition(E, M, N, K, bits, ab, G, ranks=C, cols=NT)
                    except ValueError:      # more ranks than K has windows
                        continue
                    if part in seen:
                        continue
                    seen.add(part)
                    one(op, E, M, K, N, bits, G,
                        mark="  <- expert_partition" if part == pick else "",
                        ranks=C, cols=NT)


if __name__ == "__main__":
    raise SystemExit(main())
