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
              2816x1024; M = 1, 4, 32), with kernel, plain, library
              (torch.matmul of bf16 activations against the pre-dequantized
              bf16 weight) and bound times
  5 engine    qwen1.5-0.5b at full width with seeded random weights, packed
              under w2a2, w2a16 and w2a8_bs in turn, serving 12 requests
              through the paged engine via repro_torch.launch.serve; launch
              counts set to 0 just before each run and read just after: the
              plan's kernel launches 7 x 24 times per forward, the others 0
  6 plain     the same runs with the registry forced onto the plain
              versions on the card (no kernel launches): under w2a2 and
              w2a8_bs, whose kernels are bit-identical to their plain
              versions, greedy tokens and first-decode-step logits must be
              identical; w2a16 first-decode-step logits within the stated
              tolerance
  7 profile   torch.profiler over a few engine steps of each plan: wall
              and device-busy time per step (the device's idle share),
              kernels per step, and the top host and device ops; the
              port's standing source of the idle share until it has a
              benchmark of its own

Any failure exits nonzero. The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}. Without a CUDA
card, or without the repository's src/repro_torch beside this file, it
exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
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
# differs from the plain version's. dequant_matmul sums f32 FMAs in another
# order than torch.matmul. lut_gemm_bs_fused quantizes the rows with the
# plain version's arithmetic and sums exact integers, so per channel it must
# be bit-identical; its group-scale sum runs in another order.
TOL_LUT_GROUPED = 1e-5      # relative to max|plain|
TOL_DEQUANT = 1e-5          # relative to max|plain|
TOL_BS_GROUPED = 1e-5       # relative to max|plain|
TOL_LOGITS = 2e-2           # w2a16 first decode step, relative to max|logit|

SHAPES = ((1024, 1024), (1024, 2816), (2816, 1024))   # (K, N) per projection
ROWS = (1, 4, 32)                                      # decode / prefill chunk
REPRESENTATIVE = (4, 1024, 2816)                       # (M, K, N) in the JSON


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

    def record(name, cfg, M, K, N, err, tol_ok, k_ms, p_ms, l_ms, b, by):
        row = {"kernel": name, "cfg": cfg, "M": M, "K": K, "N": N,
               "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "bound_ms": b, "bound_by": by}
        rows[name].append(row)
        print(f"  {name:17s} {cfg:14s} M={M:<3d} K={K:<5d} N={N:<5d} "
              f"err={err:.3g} kernel={k_ms:.5f}ms plain={p_ms:.5f}ms "
              f"library={l_ms:.5f}ms bound={b:.5f}ms ({by})", flush=True)
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
                ok = err <= TOL_DEQUANT * max(1.0, want.abs().max().item())
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
                       l_ms, b, by)
    return rows


def run_engine(torch, serve, cfg, qparams, args, capture: dict):
    """One serve run through the CLI's code path; checks every decode
    step's logits are finite and keeps the first step's."""
    engine = serve.make_engine(cfg, qparams, args)
    inner = engine._decode_fn

    def checked(*a):
        logits = inner(*a)
        if not bool(torch.isfinite(logits).all()):
            fail(f"{cfg.quant} produced non-finite logits")
        capture.setdefault("first_logits", logits.clone())
        return logits

    engine._decode_fn = checked
    res = serve.serve_paged(cfg, qparams, args, engine=engine)
    if not all(r.done for r in res["requests"]):
        fail("not every request finished")
    return res


def phase_profile(torch, serve, cfg, qparams, args, steps: int = 4) -> dict:
    """Profile ``steps`` engine steps of the serve workload, taken once
    the first requests decode (a mix of decode and prefill-chunk steps,
    as served)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = serve.make_engine(cfg, qparams, args)
    for r in serve.make_requests(cfg, args):
        engine.submit(r)
    while engine.decode_steps < 4:
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
    by_dev: dict = {}
    for e in dev:
        by_dev[e.name] = by_dev.get(e.name, 0.0) + e.time_range.elapsed_us()
    top_dev = sorted(by_dev.items(), key=lambda kv: -kv[1])[:5]
    top_cpu = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:6]
    out = {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "kernels_per_step": len(dev) / steps,
           "top_device_ms_per_step": [(n[:60], us / 1e3 / steps) for n, us in top_dev],
           "top_host_self_ms_per_step": [(a.key[:60], a.self_cpu_time_total / 1e3 / steps)
                                         for a in top_cpu]}
    print(f"[7 profile] {args.plan}, {steps} engine steps: "
          f"wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
          f"(idle share {out['idle_share']:.3f}), {out['kernels_per_step']:.0f} "
          f"kernels/step", flush=True)
    print("  top device: " + "; ".join(f"{n} {ms:.3f}ms" for n, ms in
                                       out["top_device_ms_per_step"]), flush=True)
    print("  top host (self): " + "; ".join(f"{n} {ms:.3f}ms" for n, ms in
                                            out["top_host_self_ms_per_step"]),
          flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a card")
    if not (SRC / "repro_torch" / "kernels" / "build.py").exists():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_dequant_matmul import dequant_matmul_cuda
    from repro_torch.kernels.lut_gemm import lut_gemm_cuda
    from repro_torch.kernels.lut_gemm_bitsliced import lut_gemm_bs_fused_cuda
    from repro_torch.launch import serve

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
          f"dequant_matmul {TOL_DEQUANT} rel, lut_gemm_bs_fused exact / "
          f"grouped {TOL_BS_GROUPED} rel)", flush=True)
    rows = phase_kernels(torch, dev)

    wrappers = {"lut_gemm": lut_gemm_cuda, "dequant_matmul": dequant_matmul_cuda,
                "lut_gemm_bs_fused": lut_gemm_bs_fused_cuda}
    plan_op = {"w2a2": "lut_gemm", "w2a16": "dequant_matmul",
               "w2a8_bs": "lut_gemm_bs_fused"}

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

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
        want = 7 * cfg.n_layers * forwards
        print(f"[5 engine] {cfg.name} {plan} (int8 pool, full width): "
              f"{len(res_k['requests'])} requests, {res_k['tokens']} tokens, "
              f"{res_k['tok_per_s']:.1f} tok/s, decode-only step "
              f"{res_k['decode_step_ms']:.3f} ms on {smi} | launches {launches} "
              f"over {forwards} forwards", flush=True)
        if launches != {name: want if name == op else 0 for name in wrappers}:
            fail(f"{plan}: launches {launches}, expected {op} 7 x "
                 f"{cfg.n_layers} x {forwards} = {want} and the others 0")

        # 6: the same run with the registry forced onto the plain versions
        cfg_p = dataclasses.replace(
            cfg, quant=dataclasses.replace(cfg.quant, backend="ref"))
        cap_p: dict = {}
        reset_launches()
        res_p = run_engine(torch, serve, cfg_p, qparams, args, cap_p)
        if any(w.launches for w in wrappers.values()):
            fail("the plain-version run launched a kernel")
        toks_k = [r.out for r in res_k["requests"]]
        toks_p = [r.out for r in res_p["requests"]]
        same = sum(a == b for a, b in zip(toks_k, toks_p))
        lk, lp = cap_k["first_logits"], cap_p["first_logits"]
        rel = ((lk - lp).abs().max() / lp.abs().max()).item()
        print(f"[6 plain] {plan}: plain-version run {res_p['tok_per_s']:.1f} "
              f"tok/s; greedy tokens identical for {same}/{len(toks_k)} "
              f"requests; first decode step logits max rel diff {rel:.3g}",
              flush=True)
        if plan in ("w2a2", "w2a8_bs") and (same != len(toks_k) or rel != 0.0):
            fail(f"{plan}: kernel and plain paths differ (tokens identical for "
                 f"{same}/{len(toks_k)} requests, first-step logits by {rel})")
        if plan == "w2a16" and rel > TOL_LOGITS:
            fail(f"w2a16 first-step logits differ by {rel} > {TOL_LOGITS}")
        results[plan] = {"launches": launches, "tok_per_s": res_k["tok_per_s"],
                         "decode_step_ms": res_k["decode_step_ms"],
                         "plain_tok_per_s": res_p["tok_per_s"],
                         "plain_decode_step_ms": res_p["decode_step_ms"],
                         "tokens_identical": same, "logits_rel_diff": rel,
                         "profile": phase_profile(torch, serve, cfg, qparams, args)}

    print("[results] " + json.dumps({"engine": results}), flush=True)
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
                                     "w2a8_bs bf16")}
    kernels = []
    for name, (src, replaces, launches, cfg_name) in sources.items():
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
