"""Serve a packed model through the port's paged continuous-batching engine.

The port's counterpart of ``repro/launch/serve.py`` (``--paged`` path):
random weights from ``--seed`` -> offline quantize+pack under a plan ->
a stream of mixed-length requests admitted through chunked prefill into the
paged pool and decoded greedily, every planned projection running through
its kernel (``lut_gemm`` for w{b}a{b}, ``dequant_matmul`` for w{b}a16,
``lut_gemm_bs_fused`` for the bit-sliced w2a8_bs, w2a8_bs_g64 and w4a8_bs).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --paged --plan w2a2                      # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --paged --plan w2a8_bs                   # bit-sliced, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --smoke --paged --device cpu             # tiny, plain versions on CPU

It takes the reference's flags. Those of features not ported yet are
rejected loudly, as is running without ``--paged`` (the fixed-batch loop
waits for ROADMAP queue 1, item 6). Prompts come from numpy's
``default_rng(seed)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.qplan import PLANS, get_plan, make_plan
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving import Engine, Request


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--w-bits", type=int, default=2)
    ap.add_argument("--a-bits", type=int, default=None)
    ap.add_argument("--group-size", type=int, default=None)
    ap.add_argument("--plan", default=None,
                    help=f"named plan preset ({', '.join(sorted(PLANS))}); "
                         "overrides --w-bits/--a-bits/--group-size")
    ap.add_argument("--nonuniform", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefill-batch", type=int, default=1)
    ap.add_argument("--prefill", default="chunked", choices=("chunked", "whole"))
    ap.add_argument("--kv-splits", default="auto")
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--spec-draft-plan", default=None)
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--a-scale", default="dynamic", choices=("dynamic", "static"))
    ap.add_argument("--calib-batches", type=int, default=4)
    return ap


def validate_args(args) -> None:
    """Reject flags of features the port does not carry yet, loudly."""
    item6 = "ROADMAP queue 1, item 6"
    checks = [
        (not args.paged, "running without --paged is not ported: the "
         f"fixed-batch loop waits for {item6}; pass --paged"),
        (args.prefix_cache, f"--prefix-cache (radix cache) is not ported yet: {item6}"),
        (args.prefill_batch > 1, f"--prefill-batch > 1 is not ported yet: {item6}"),
        (args.prefill == "whole", f"--prefill whole is not ported yet: {item6}"),
        (args.spec_draft_plan is not None,
         f"--spec-draft-plan (speculative decoding) is not ported yet: {item6}"),
        (args.ring, f"--ring (ring-paged local layers) is not ported yet: {item6}"),
        (args.kv_splits not in ("auto", "1"),
         f"--kv-splits > 1 (split-KV decode) is not ported yet: {item6}"),
        (args.tp > 1, "--tp > 1 is not ported yet: ROADMAP queue 1, item 11"),
        (args.trace_out is not None, f"--trace-out (tracer) is not ported yet: {item6}"),
        (args.a_scale == "static", "--a-scale static (calibration) is not "
         "ported yet: ROADMAP queue 1, item 2"),
        (args.nonuniform, "--nonuniform (k-means codebooks) is not ported "
         "yet: ROADMAP queue 1, item 2"),
        (args.plan == "legacy", "--plan legacy (dequant-einsum leaves) is not "
         "ported: pick a kernel-backed plan"),
        (args.temperature > 0 or args.top_k or args.top_p < 1.0,
         "--temperature/--top-k/--top-p (seeded sampling) are not ported yet: "
         "ROADMAP queue 1, item 5; the port decodes greedily"),
    ]
    for bad, msg in checks:
        if bad:
            raise ValueError(msg)
    if args.plan is not None and args.plan not in PLANS:
        raise ValueError(f"unknown --plan {args.plan!r} "
                         f"({', '.join(sorted(PLANS))})")


def make_quant(args):
    """The plan the flags ask for, and a one-line description."""
    if args.plan is not None:
        return get_plan(args.plan), f"plan '{args.plan}'"
    a = f"a{args.a_bits}" if args.a_bits else "a16"
    g = f" g{args.group_size}" if args.group_size else ""
    return (make_plan(args.w_bits, args.a_bits, args.group_size),
            f"plan w{args.w_bits}{a}{g}")


def make_requests(cfg, args) -> list[Request]:
    """``args.requests`` mixed-length prompts (4..prompt_len tokens) from
    numpy's default_rng(seed)."""
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(4, args.prompt_len + 1, size=args.requests)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(P)),
                    max_new=args.gen) for i, P in enumerate(lens)]


def make_engine(cfg, qparams, args) -> Engine:
    max_len = args.prompt_len + args.gen + args.block_size
    max_len = -(-max_len // args.block_size) * args.block_size
    return Engine(cfg, qparams, n_slots=args.batch, max_len=max_len,
                  block_size=args.block_size, max_queue=args.max_queue,
                  kv_splits=args.kv_splits)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_paged(cfg, qparams, args, engine: Engine | None = None) -> dict:
    """Run the request stream through the engine; print and return the
    run's numbers (requests, tokens, wall time, mean time of steps that
    only decoded)."""
    engine = engine if engine is not None else make_engine(cfg, qparams, args)
    reqs = make_requests(cfg, args)
    for r in reqs:
        if not engine.submit(r):
            print(f"  [req {r.uid}] rejected (queue full)")
    dev = engine.device
    _sync(dev)
    t0 = time.perf_counter()
    decode_only = []
    while engine.queue or any(s.req is not None for s in engine.slots):
        pc, ds = engine.prefill_chunks, engine.decode_steps
        ts = time.perf_counter()
        engine.step()
        _sync(dev)
        if engine.prefill_chunks == pc and engine.decode_steps == ds + 1:
            decode_only.append(time.perf_counter() - ts)
    dt = time.perf_counter() - t0
    m = engine.metrics()
    done = [r for r in reqs if r.done]
    n_tok = sum(len(r.out) for r in done)
    step_ms = 1e3 * sum(decode_only) / len(decode_only) if decode_only else None
    print(f"  paged engine: {len(done)}/{len(reqs)} requests, {n_tok} tokens "
          f"in {dt:.3f}s ({n_tok / max(dt, 1e-9):.1f} tok/s) | decode steps "
          f"{m['decode_steps']}, prefill chunks {m['prefill_chunks']}, "
          f"preemptions {m['preemptions']}, util {m['slot_utilization']:.2f}"
          + (f", decode-only step {step_ms:.3f} ms" if step_ms else ""))
    ops: dict = {}
    for k, v in m["metrics"]["counters"].items():
        if k.startswith("kernel_dispatch_total"):
            labels = dict(p.split("=", 1) for p in k[k.index("{") + 1:-1].split(","))
            key = f"{labels['op']}:{labels['backend']}"
            ops[key] = ops.get(key, 0) + int(v)
    print(f"  kernel dispatches: {ops}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            json.dump(m, fh, indent=1, default=float)
    return {"requests": reqs, "metrics": m, "seconds": dt, "tokens": n_tok,
            "tok_per_s": n_tok / max(dt, 1e-9), "decode_step_ms": step_ms,
            "dispatches": ops, "engine": engine}


def prepare(args):
    """Config, plan and packed parameters for ``args`` on its device."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    quant, desc = make_quant(args)
    cfg = dataclasses.replace(cfg, quant=quant)
    print(f"[serve] {cfg.name} on {device}: packing weights under {desc}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device)
    qparams = lm.quantize_tree(params, cfg)
    _sync(device)
    print(f"  initialised and packed in {time.perf_counter() - t0:.2f}s")
    return cfg, qparams


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        validate_args(args)
    except ValueError as e:
        ap.error(str(e))
    cfg, qparams = prepare(args)
    serve_paged(cfg, qparams, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
