"""Serve a packed model through the port: the fixed-batch loop, or with
``--paged`` the paged continuous-batching engine.

The port's counterpart of ``repro/launch/serve.py``: random weights from
``--seed`` -> offline quantize+pack under a plan, every planned projection
running through its kernel (``lut_gemm`` for w{b}a{b}, ``dequant_matmul``
for w{b}a16, ``lut_gemm_bs_fused`` for the bit-sliced w2a8_bs, w2a8_bs_g64
and w4a8_bs, and ``lut_gemm_bitsliced`` for their row-parallel
projections under ``--tp``). On an MoE model every expert projection runs
through ``expert_lut_gemm`` (w{b}a{b}) or ``expert_dequant_matmul``
(w{b}a16 and the bit-sliced plans). Weights are drawn and packed one layer at a time.

Without ``--paged`` (``serve_fixed``): ``--batch`` prompts of
``--prompt-len`` tokens are prefilled in one batch into dense slot caches
of prompt-len + gen rows, then decoded greedily for ``--gen`` - 1 steps;
decode attention over the int8/int4 cache runs through
``kv_cache_attention``. With ``--paged`` (``serve_paged``): a stream of
``--requests`` mixed-length requests is admitted through chunked prefill
into the paged pool; decode attention runs through ``paged_attention``,
or with ``--kv-splits N`` (N > 1; "auto" follows the card's rule,
``kernels/paged_attention.py::auto_kv_splits``: 24 chunks from 32768 rows
of context for up to 64 slot and KV-head walks, else 1) through the
split-KV ``paged_attention_splitkv``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --plan w2a2                              # fixed batch, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --paged --plan w2a8_bs                   # paged engine, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \
      --paged --plan w2a8_bs                   # int4 pool, untied head
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch moonshot-v1-16b-a3b --paged --plan w2a2   # MoE, 48 layers
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --smoke --device cpu                     # tiny, plain versions on CPU
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch moonshot-v1-16b-a3b --smoke --paged --device cpu --plan w2a16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --paged --tp 2 --plan w2a8_bs            # 2 ranks, tensor-parallel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --smoke --paged --tp 2 --device cpu      # 2 gloo ranks on the CPU

With ``--tp N`` (``--paged`` only) N ranks are spawned
(``launch/mesh.py``): every rank draws the same weights, packs them for N
ranks and keeps its slice of each planned projection, then serves the
same request stream; rank 0 prints. Column-parallel projections (wq, wk,
wv, w_gate, w_up) run their op on the rank's N slice and gather the
outputs; row-parallel ones (wo, w_down) run on the rank's K slice and sum
over the ranks, a bit-sliced leaf through the two-step
``lut_gemm_bitsliced``. Attention, norms and the embedding run whole on
every rank. Ranks on one card talk through gloo, ranks on cards of their
own through NCCL. MoE models under ``--tp`` wait for the expert TP rules
(ROADMAP queue 1, item 11).

The paged engine's serving features follow the reference's flags:
``--prefix-cache`` (the radix cache), ``--prefill-batch N`` (N requests a
prefill chunk), ``--prefill whole`` (whole-prompt admission),
``--temperature`` / ``--top-k`` / ``--top-p`` with ``--seed`` (seeded
sampling), ``--spec-draft-plan PLAN`` with ``--spec-k`` (speculative
decoding with a drafter packed from the same weights under PLAN),
``--ring`` (ring-paged local layers: a sliding-window arch's local layers
keep a ring of blocks a slot, flat in the context) and ``--trace-out
PATH`` (the request tracer: prints the TTFT / TPOT percentiles and the
step phases, and writes a Chrome trace, or JSONL for a ``.jsonl`` path,
which ``python -m repro_torch.analysis.report trace PATH`` renders):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --paged --plan w2a8_bs --prefix-cache --prefill-batch 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --paged --plan w2a8_bs --spec-draft-plan w2a2 --temperature 0.8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
      --paged --plan w2a8_bs --ring --trace-out trace.json

It takes the reference's rules: the engine's features (``--prefix-cache``,
``--prefill-batch`` > 1, ``--tp`` > 1, ``--spec-draft-plan``, an explicit
``--kv-splits``, ``--ring``, ``--trace-out``, ``--metrics-out``) require
``--paged``; ``--prefix-cache`` and ``--spec-draft-plan`` refuse
``--prefill whole``; ``--ring`` needs a sliding-window arch and refuses
``--prefix-cache``. One rule is the port's own: the sampling flags
require ``--paged`` (the reference's fixed loop ignores them and decodes
greedily). Flags of features not ported yet are rejected loudly: static
activation scales and k-means codebooks (ROADMAP queue 1, item 2), the
legacy plan, MoE under ``--tp``, and speculative decoding under ``--tp``
(the drafter's TP rules, ROADMAP queue 1, item 11). ``--ring`` under
``--tp`` runs: the rings are host-side, and every rank holds the whole
pool. Prompts come from
numpy's ``default_rng(seed)``; the reference draws them with JAX's
threefry, whose numbers are not reproduced. The enc-dec and vision inputs
of the reference's fixed loop come with their families (ROADMAP queue 1,
item 9).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.core.qplan import PLANS, get_plan, make_plan
from repro_torch.device import resolve_device
from repro_torch.kernels import registry
from repro_torch.launch import mesh
from repro_torch.launch import steps as St
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import Tracer
from repro_torch.serving import Engine, Request, SamplerConfig


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
    ap.add_argument("--kv-splits", default="auto",
                    help="split-KV decode chunks: auto or an int >= 1")
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
    """Reject incoherent flag combinations (the reference's rules), then
    flags of features the port does not carry yet, loudly."""
    if not args.paged:
        needs_paged = [
            (args.prefix_cache, "--prefix-cache", "the radix cache shares "
             "blocks of the paged engine's pool"),
            (args.prefill_batch > 1, "--prefill-batch", "batched prefill "
             "chunks are a paged-engine feature"),
            (args.tp > 1, "--tp", "tensor-parallel serving runs through the "
             "engine's step functions"),
            (args.spec_draft_plan is not None, "--spec-draft-plan",
             "speculative decoding runs through the engine"),
            (args.kv_splits != "auto", "--kv-splits", "split-KV decode "
             "partitions the paged engine's block tables"),
            (args.ring, "--ring", "ring-paged local layers replace the paged "
             "engine's block tables"),
            (args.trace_out is not None, "--trace-out", "request-lifecycle "
             "tracing hooks into the paged engine's loop"),
            (args.metrics_out is not None, "--metrics-out", "the metrics "
             "snapshot is the paged engine's registry"),
            (args.temperature > 0 or args.top_k or args.top_p < 1.0,
             "--temperature/--top-k/--top-p", "the sampler runs in the "
             "paged engine's decode step"),
        ]
        for bad, flag, why in needs_paged:
            if bad:
                raise ValueError(f"{flag} requires --paged: {why}; the "
                                 "fixed-batch loop has none")
    if args.prefix_cache and args.prefill == "whole":
        raise ValueError("--prefix-cache is incompatible with --prefill whole: "
                         "whole-prompt admission recomputes from scratch and "
                         "cannot consume cached blocks; use --prefill chunked")
    if args.spec_draft_plan is not None:
        if args.prefill == "whole":
            raise ValueError("--spec-draft-plan is incompatible with --prefill "
                             "whole: the drafter's catch-up prefill replays the "
                             "fed-token stream in chunks; use --prefill chunked")
        if args.spec_draft_plan not in PLANS:
            raise ValueError(f"--spec-draft-plan {args.spec_draft_plan!r} is not "
                             f"a known plan ({', '.join(sorted(PLANS))})")
    if args.spec_k < 1:
        raise ValueError(f"--spec-k must be >= 1, got {args.spec_k}")
    if args.temperature < 0:
        raise ValueError(f"--temperature must be >= 0 (0 = greedy), got "
                         f"{args.temperature}")
    if not 0.0 < args.top_p <= 1.0:
        raise ValueError(f"--top-p must be in (0, 1] (1 = off), got {args.top_p}")
    if args.top_k < 0:
        raise ValueError(f"--top-k must be >= 0 (0 = off), got {args.top_k}")
    if args.prefill_batch < 1:
        raise ValueError(f"--prefill-batch must be >= 1, got {args.prefill_batch}")
    if args.ring and args.arch in ARCHS:
        cfg = get_config(args.arch)
        if "local" not in cfg.layer_types() or not cfg.window:
            raise ValueError(f"--ring requires a sliding-window arch: '{cfg.name}' "
                             "has no local attention layers to ring-page")
    if args.ring and args.prefix_cache:
        raise ValueError("--ring is incompatible with --prefix-cache: ring blocks "
                         "are per-slot and rewritten in place, so local-layer KV "
                         "can never be shared across requests")
    checks = [
        (args.tp > 1 and args.arch in ARCHS
         and get_config(args.arch).moe is not None,
         "--tp > 1 on an MoE model (the expert TP rules) is not ported yet: "
         "ROADMAP queue 1, item 11"),
        (args.tp > 1 and args.spec_draft_plan is not None,
         "--spec-draft-plan under --tp > 1 (the drafter's TP rules) is not "
         "ported yet: ROADMAP queue 1, item 11"),
        (args.a_scale == "static", "--a-scale static (calibration) is not "
         "ported yet: ROADMAP queue 1, item 2"),
        (args.nonuniform, "--nonuniform (k-means codebooks) is not ported "
         "yet: ROADMAP queue 1, item 2"),
        (args.plan == "legacy", "--plan legacy (dequant-einsum leaves) is not "
         "ported: pick a kernel-backed plan"),
    ]
    for bad, msg in checks:
        if bad:
            raise ValueError(msg)
    if args.tp < 1:
        raise ValueError(f"--tp must be >= 1, got {args.tp}")
    if args.kv_splits != "auto" and not (args.kv_splits.isdigit()
                                         and int(args.kv_splits) >= 1):
        raise ValueError(f"--kv-splits must be auto or an int >= 1, got "
                         f"{args.kv_splits!r}")
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


def make_engine(cfg, qparams, args, spec=None, **engine_kw) -> Engine:
    """The engine the flags ask for; ``spec`` is the drafter's ``(cfg,
    params)`` (``prepare_drafter``) and ``engine_kw`` reaches ``Engine``
    (a caller's ``attn_backend``, a rank's ``tp_group``)."""
    max_len = args.prompt_len + args.gen + args.block_size
    max_len = -(-max_len // args.block_size) * args.block_size
    if spec is not None:
        engine_kw.update(spec_draft_cfg=spec[0], spec_draft_params=spec[1],
                         spec_k=args.spec_k)
    sampler = SamplerConfig(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed)
    engine_kw.setdefault("ring", args.ring)
    return Engine(cfg, qparams, n_slots=args.batch, max_len=max_len,
                  block_size=args.block_size, max_queue=args.max_queue,
                  prefill=args.prefill, prefill_batch=args.prefill_batch,
                  prefix_cache=args.prefix_cache, sampler=sampler,
                  kv_splits=args.kv_splits, **engine_kw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dispatch_counts(counters: dict) -> dict:
    """``{"op:backend": calls}`` from ``kernel_dispatch_total`` counters."""
    ops: dict = {}
    for k, v in counters.items():
        if k.startswith("kernel_dispatch_total"):
            labels = dict(p.split("=", 1) for p in k[k.index("{") + 1:-1].split(","))
            key = f"{labels['op']}:{labels['backend']}"
            ops[key] = ops.get(key, 0) + int(v)
    return ops


def serve_fixed(cfg, qparams, args, decode_step=None) -> dict:
    """The fixed-batch loop (reference serve.py:444-490): ``args.batch`` x
    ``args.prompt_len`` prompt tokens from numpy's default_rng(seed) (the
    reference's come from JAX's threefry and are not reproduced), one
    batched prefill into dense slot caches of prompt_len + gen rows, the
    greedy argmax, then gen - 1 decode steps at pos = P + i. Prints the
    prefill time, decode tok/s and the sample generation of batch 0;
    returns the run's numbers with the tokens (B, gen) and the first
    decode step's logits. ``decode_step`` replaces
    ``steps.make_decode_step(cfg)`` (a caller's attention backend or
    checks); every step ends in a device synchronise, so the decode-only
    step time is a mean of whole steps."""
    dev = lm.embed_table(qparams).device
    B, P = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, P))).to(dev)
    prefill = St.make_prefill_step(cfg, max_len=P + args.gen)
    decode = decode_step if decode_step is not None else St.make_decode_step(cfg)
    with obs_metrics.scoped() as reg:
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(qparams, {"tokens": tokens})
        out = [logits[:, -1].argmax(-1)]
        _sync(dev)
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        steps, first_logits = [], None
        for i in range(args.gen - 1):
            ts = time.perf_counter()
            pos = torch.full((B,), P + i, dtype=torch.int64, device=dev)
            logits, caches = decode(qparams, caches,
                                    {"tokens": out[-1][:, None], "pos": pos})
            out.append(logits[:, -1].argmax(-1))
            _sync(dev)
            steps.append(time.perf_counter() - ts)
            if first_logits is None:
                first_logits = logits
    gen = torch.stack(out, dim=1).cpu().numpy()
    n_tok = B * (args.gen - 1)
    t_dec = sum(steps)
    step_ms = 1e3 * t_dec / len(steps) if steps else None
    print(f"  prefill {B}x{P}: {prefill_ms:.1f} ms")
    print(f"  decode: {n_tok} tokens in {1e3 * t_dec:.1f} ms "
          f"({n_tok / max(t_dec, 1e-9):.1f} tok/s)"
          + (f", decode-only step {step_ms:.3f} ms" if step_ms else ""))
    print(f"  sample generation (batch 0): {gen[0].tolist()}")
    ops = _dispatch_counts(reg.snapshot()["counters"])
    print(f"  kernel dispatches: {ops}")
    return {"tokens": gen, "first_logits": first_logits, "prefill_ms": prefill_ms,
            "seconds": t_dec, "decoded": n_tok,
            "tok_per_s": n_tok / max(t_dec, 1e-9), "decode_step_ms": step_ms,
            "dispatches": ops}


def serve_paged(cfg, qparams, args, engine: Engine | None = None,
                requests: list | None = None) -> dict:
    """Run the request stream (``make_requests``, or ``requests``) through
    the engine; print and return the run's numbers (requests, tokens, wall
    time, mean time of the steps that only decoded: no prefill chunk,
    whole prompt or drafter catch-up). With ``--trace-out`` a ``Tracer``
    is attached unless the engine has one; its latency and phase summaries
    are printed and its trace written there."""
    engine = engine if engine is not None else make_engine(cfg, qparams, args)
    if args.trace_out and engine.tracer is None:
        engine.attach_tracer(Tracer())
    reqs = requests if requests is not None else make_requests(cfg, args)
    for r in reqs:
        if not engine.submit(r):
            print(f"  [req {r.uid}] rejected (queue full)")
    dev = engine.device
    _sync(dev)
    t0 = time.perf_counter()
    decode_only = []
    while engine.queue or any(s.req is not None for s in engine.slots):
        before = (engine.prefill_tokens_computed, engine.spec_draft_prefills,
                  engine.decode_steps + 1)
        ts = time.perf_counter()
        engine.step()
        _sync(dev)
        if (engine.prefill_tokens_computed, engine.spec_draft_prefills,
                engine.decode_steps) == before:
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
    if m["spec"] is not None:
        sp = m["spec"]
        print(f"  spec decode: {sp['accepted_tokens_per_step']:.2f} tokens/"
              f"slot-step (acceptance {sp['acceptance_rate']:.2f} over "
              f"{sp['draft_tokens']} drafts, {sp['rounds']} rounds, "
              f"{sp['draft_evictions']} drafter evictions)")
    if m["prefix_cache"] is not None:
        total = m["prefill_tokens_computed"] + m["prefill_tokens_shared"]
        print(f"  prefix cache: {m['prefill_tokens_shared']}/{total} prompt "
              f"tokens attached from cache "
              f"({m['prefix_cache']['cached_blocks']} blocks cached, "
              f"{m['prefix_cache']['evictions']} evictions)")
    ops = _dispatch_counts(m["metrics"]["counters"])
    print(f"  kernel dispatches: {ops}")
    if engine.ring_len:
        print(f"  ring-paged local layers: rings of {engine.ring_len} blocks, "
              f"{engine.n_ring_blocks} ring-pool blocks against "
              f"{engine.n_blocks} in the main pool; peak blocks a request "
              f"{m['pool_blocks_peak']}")
    if engine.tracer is not None:
        print_trace(engine.tracer, args.trace_out)
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            json.dump(m, fh, indent=1, default=float)
    return {"requests": reqs, "metrics": m, "seconds": dt, "tokens": n_tok,
            "tok_per_s": n_tok / max(dt, 1e-9), "decode_step_ms": step_ms,
            "dispatches": ops, "engine": engine}


def print_trace(tracer, path: str | None) -> None:
    """Print a tracer's TTFT / TPOT percentiles and phase totals, and
    export it to ``path`` where given (JSONL for a ``.jsonl`` path, else a
    Chrome trace), as the reference's serve.py:258-275 does."""
    lat, ph = tracer.latency_summary(), tracer.phase_summary()

    def pct(stat):
        s = lat[stat]
        if not s["count"]:
            return f"{stat}: n/a"
        return (f"{stat} p50/p95/p99 {1e3 * s['p50']:.1f}/{1e3 * s['p95']:.1f}/"
                f"{1e3 * s['p99']:.1f} ms")

    print(f"  latency: {pct('ttft_s')} | {pct('tpot_s')}")
    tot = ph["total_s"]
    print("  phases (s): " + ", ".join(f"{k}={tot[k]:.3f}" for k in sorted(tot)))
    if path:
        tracer.export(path)
        kind = "JSONL" if path.endswith(".jsonl") else \
            "Chrome trace; load in ui.perfetto.dev"
        print(f"  trace written to {path} ({kind}); render it with python -m "
              f"repro_torch.analysis.report trace {path}")


def config_for(args):
    """The config of ``--arch`` (reduced under ``--smoke``) under the
    flags' plan, and the plan's one-line description."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    quant, desc = make_quant(args)
    return dataclasses.replace(cfg, quant=quant), desc


def pack_params(cfg, args, desc: str, tp: int = 1, rank: int = 0):
    """``cfg``'s weights drawn from ``args.seed`` and packed under its plan
    on ``args.device``; with ``tp`` > 1, rank ``rank``'s slice of them.
    The target and the drafter both come from here, so the drafter's
    weights are the target's, drawn in the same order."""
    device = resolve_device(args.device)
    print(f"[serve] {cfg.name} on {device}: packing weights under {desc}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device, pack=True, tp=tp,
                            rank=rank)                   # layer by layer
    _sync(device)
    print(f"  initialised and packed in {time.perf_counter() - t0:.2f}s"
          + (f" (rank {rank}'s slice of {tp})" if tp > 1 else ""))
    return params


def prepare(args, tp: int = 1, rank: int = 0):
    """Config, plan and packed parameters for ``args`` on its device; with
    ``tp`` > 1, rank ``rank``'s slice of them."""
    cfg, desc = config_for(args)
    return cfg, pack_params(cfg, args, desc, tp, rank)


def prepare_drafter(args, cfg):
    """The drafter of ``--spec-draft-plan``: ``cfg`` under that plan with
    the same seed-drawn weights packed under it, as the reference packs
    its drafter with ``quantize_tree`` under ``replace(cfg, quant=...)``."""
    dcfg = dataclasses.replace(cfg, quant=get_plan(args.spec_draft_plan))
    return dcfg, pack_params(dcfg, args, f"the drafter's plan "
                                         f"'{args.spec_draft_plan}'")


def serve_rank(rank: int, world: int, args, check_ops: tuple = ()) -> dict:
    """One rank of ``--tp``: pack this rank's slice, serve the request
    stream through a tensor-parallel engine and return the run's numbers:
    rank 0's greedy tokens and first decode step's logits, whether every
    rank produced the same, the decode times, and per rank (``ranks``) its
    kernel launches, its parameter bytes (all, and of the ``packed`` arrays
    of its role-stamped leaves, by path) and, for each op in ``check_ops``,
    how many calls the first decode step made and the largest difference
    of any of them from the op's plain version on the same local inputs,
    relative to max|plain| (those calls also run the plain version)."""
    cfg, qparams = prepare(args, tp=world, rank=rank)
    if rank:
        args.trace_out = None            # rank 0 traces and writes the file
    engine = make_engine(cfg, qparams, args, tp_group=dist.group.WORLD)
    print(f"  rank {rank} of {world} on {engine.device} ({dist.get_backend()}): "
          f"{engine.per_device_weight_bytes()} parameter bytes")
    first: dict = {}
    errs = {name: [] for name in check_ops}
    inner = engine._decode_fn

    def decode(*a):
        with contextlib.ExitStack() as stack:
            if not first:
                for name in check_ops:
                    stack.enter_context(registry.checked_against_plain(
                        (name,), errs[name]))
            logits = inner(*a)
        first.setdefault("logits", logits.clone())
        return logits

    engine._decode_fn = decode
    before = registry.launch_counts()
    res = serve_paged(cfg, qparams, args, engine=engine)
    tokens = [r.out for r in res["requests"]]
    mine = {"tokens": tokens, "first_logits": first["logits"].cpu(),
            "launches": {k: v - before[k] for k, v in registry.launch_counts().items()},
            "weight_bytes": engine.per_device_weight_bytes(),
            "role_packed_bytes": {p: qw.packed.numel() * qw.packed.element_size()
                                  for p, qw in lm.qweights(qparams).items() if qw.tp},
            "first_step_errs": {k: max(v, default=None) for k, v in errs.items()},
            "first_step_calls": {k: len(v) for k, v in errs.items()}}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    agree = all(r["tokens"] == tokens and torch.equal(r["first_logits"],
                                                      mine["first_logits"])
                for r in ranks)
    for r in ranks:
        del r["tokens"], r["first_logits"]
    m = res["metrics"]
    return {"tokens": tokens, "first_logits": mine["first_logits"],
            "ranks_agree": agree, "ranks": ranks,
            "decode_steps": m["decode_steps"],
            "prefill_chunks": m["prefill_chunks"],
            "tok_per_s": res["tok_per_s"], "decode_step_ms": res["decode_step_ms"],
            "backend": dist.get_backend(), "device": str(engine.device)}


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        validate_args(args)
    except ValueError as e:
        ap.error(str(e))
    if args.tp > 1:
        dev = resolve_device(args.device)
        print(f"[serve] --tp {args.tp}: {args.tp} ranks over "
              f"{mesh.backend_for(args.tp, dev)} on {dev.type}")
        res = mesh.run_ranks(serve_rank, args.tp, args, device=args.device)
        print(f"  every rank produced the same tokens and first-step logits: "
              f"{res['ranks_agree']}")
        return 0 if res["ranks_agree"] else 1
    cfg, qparams = prepare(args)
    if args.paged:
        spec = prepare_drafter(args, cfg) if args.spec_draft_plan else None
        serve_paged(cfg, qparams, args,
                    engine=make_engine(cfg, qparams, args, spec=spec))
    else:
        serve_fixed(cfg, qparams, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
