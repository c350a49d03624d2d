"""The port's paged engine against the JAX reference's Engine: the same
numpy prompts and the same weights (carried across with the bridge) give
the same greedy tokens, on the float32 reduced qwen1.5-0.5b (two layers)
under w2a2 and w2a16, with an unquantized and an int8 pool. Also:
preemption under a small pool (against the reference and an ample pool),
the serve CLI with the engine's serving features, its flag rules, and the
no-fallback rule.

Where the reference's top-2 logit margin at the first diverging step is
below MARGIN_TOL, the two frameworks' f32 rounding may legitimately pick
the other token: the test then reports the step and the margin instead of
failing.

The reference engine allocates an unquantized pool in bf16 whatever the
model dtype, and its scatter then refuses f32 rows; for the float32 config
the test hands it an f32 pool, which is what the port allocates.
"""

import dataclasses
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduce_for_smoke as jreduce
from repro.core import qplan as jqplan
from repro.models import lm as jlm
from repro.serving import Engine as JEngine, Request as JRequest
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import qplan
from repro_torch.launch import serve
from repro_torch.serving import Engine, Request

KEY = jax.random.PRNGKey(0)
MARGIN_TOL = 1e-3
PROMPT_LENS = (5, 17, 9, 30)
MAX_NEW = 6
ENGINE_KW = dict(n_slots=2, max_len=64, block_size=8, chunk_size=16)

_CACHE = {}


def _setup(plan: str, kv: str):
    key = (plan, kv)
    if key not in _CACHE:
        kw = {"w2a2": dict(w_bits=2, a_bits=2), "w2a16": dict(w_bits=2)}[plan]
        jc = dataclasses.replace(jreduce(jget_config("qwen1.5-0.5b")), n_layers=2,
                                 dtype="float32", kv_cache_dtype=kv,
                                 quant=jqplan.make_plan(**kw, backend="ref"))
        tc = dataclasses.replace(reduce_for_smoke(get_config("qwen1.5-0.5b")),
                                 n_layers=2, dtype="float32", kv_cache_dtype=kv,
                                 quant=qplan.make_plan(**kw))
        qp = jlm.quantize_tree(jlm.init_params(KEY, jc), jc)
        tq = bridge.qparams_from_jax(jax.tree.map(np.asarray, qp), tc, device="cpu")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, jc.vocab_size, size=n).astype(np.int32)
                   for n in PROMPT_LENS]
        _CACHE[key] = (jc, tc, qp, tq, prompts)
    return _CACHE[key]


def _run_jax(jc, qp, prompts, **kw):
    eng = JEngine(jc, qp, **{**ENGINE_KW, **kw})
    if jc.dtype == "float32":
        eng.caches = jax.tree.map(
            lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
            eng.caches)
    margins = {}

    def greedy(logits, *_):
        lg = np.asarray(logits)
        for i, s in enumerate(eng.slots):
            if s.state == jengine._DECODE:
                top = np.sort(lg[i])[-2:]
                margins[(s.req.uid, len(s.req.out))] = float(top[1] - top[0])
        return jnp.argmax(logits, axis=-1)

    eng._sample = greedy
    reqs = [JRequest(uid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs], margins, eng


def _run_port(tc, tq, prompts, **kw):
    eng = Engine(tc, tq, **{**ENGINE_KW, **kw})
    reqs = [Request(uid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    m = eng.run()
    assert all(r.done for r in reqs)
    assert eng.pool.n_free == eng.n_blocks - 1       # every block returned
    return [r.out for r in reqs], m


def _same_or_near_tie(want, got, margins):
    for uid, (w, g) in enumerate(zip(want, got)):
        if w == g:
            continue
        step = next(i for i, (a, b) in enumerate(zip(w, g)) if a != b)
        margin = margins[(uid, step)]
        assert margin < MARGIN_TOL, (
            f"request {uid} diverges at step {step} with reference top-2 "
            f"margin {margin} >= {MARGIN_TOL}: {w} vs {g}")
        warnings.warn(f"request {uid} diverges at step {step}: reference "
                      f"top-2 margin {margin} < {MARGIN_TOL} (near tie)")


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("plan", ["w2a2", "w2a16"])
def test_greedy_tokens_match_reference_engine(plan, kv):
    jc, tc, qp, tq, prompts = _setup(plan, kv)
    want, margins, jeng = _run_jax(jc, qp, prompts)
    got, m = _run_port(tc, tq, prompts)
    _same_or_near_tie(want, got, margins)
    assert m["decode_steps"] == jeng.decode_steps
    assert m["prefill_chunks"] == jeng.prefill_chunks
    op = "lut_gemm" if plan == "w2a2" else "dequant_matmul"
    counts = m["metrics"]["counters"]
    n = sum(v for k, v in counts.items() if k.startswith(f"kernel_dispatch_total{{")
            and f"op={op}" in k)
    assert n == 7 * tc.n_layers * (m["decode_steps"] + m["prefill_chunks"])


@pytest.mark.parametrize("n_blocks", [6, 7])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_preemption_matches_reference_and_ample_pool(kv, n_blocks):
    """A pool too small for every request at once forces recompute
    preemption, with the reference's outcome. With 6 blocks the victim is
    evicted while still prefilling, so its tokens are those of an ample
    pool. With 7 it is evicted after two decode steps: it re-prefills
    prompt + generated tokens, a stream without the re-fed last prompt
    token the first decode step had added, so from there its tokens
    follow that new context — in both engines alike."""
    jc, tc, qp, tq, prompts = _setup("w2a2", kv)
    small, m = _run_port(tc, tq, prompts, n_blocks=n_blocks)
    assert m["preemptions"] >= 1
    want, margins, jeng = _run_jax(jc, qp, prompts, n_blocks=n_blocks)
    assert jeng.preemptions == m["preemptions"]
    _same_or_near_tie(want, small, margins)
    if n_blocks == 6:
        ample, _ = _run_port(tc, tq, prompts)
        assert ample == small


def test_engine_rejects_what_is_not_ported():
    _, tc, _, tq, _ = _setup("w2a2", "int8")
    eng = Engine(tc, tq, **ENGINE_KW)
    assert not eng.submit(Request(uid=0, prompt=np.zeros(64, np.int32)))


def test_serve_cli_smoke_on_cpu_exits_zero():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-0.5b", "--smoke", "--paged", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stderr
    assert "12/12 requests" in out.stdout


@pytest.mark.parametrize("flags", [
    ["--prefill", "whole"], ["--prefix-cache", "--prefill-batch", "2"],
    ["--spec-draft-plan", "w2a2", "--spec-k", "3"],
    ["--spec-draft-plan", "w2a2", "--temperature", "0.8"],
    ["--temperature", "0.7", "--top-k", "5", "--top-p", "0.9", "--seed", "3"]])
def test_serve_cli_feature_smoke_on_cpu(flags):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-0.5b", "--smoke", "--paged", "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stderr
    assert "12/12 requests" in out.stdout


@pytest.mark.parametrize("flags", [
    ["--tp", "2", "--arch", "moonshot-v1-16b-a3b"],
    ["--tp", "2", "--spec-draft-plan", "w2a2"]])
def test_serve_rejects_unported_flags_loudly(flags):
    args = serve.build_parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--paged", *flags])
    with pytest.raises(ValueError, match="not ported|ROADMAP"):
        serve.validate_args(args)


@pytest.mark.parametrize("flags", [
    ["--plan", "w2a2", "--a-scale", "static"], ["--a-bits", "2", "--a-scale", "static",
                                                "--calib-batches", "2"],
    ["--nonuniform"], ["--plan", "w2a2", "--nonuniform"],
    ["--plan", "legacy"], ["--plan", "legacy", "--nonuniform"]])
def test_serve_accepts_the_quantization_front_end_flags(flags):
    """--a-scale static, --nonuniform and --plan legacy are ported: the
    flag rules take them (their runs: tests/test_torch_quant_front.py)."""
    args = serve.build_parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--paged", *flags])
    serve.validate_args(args)


@pytest.mark.parametrize("flags,msg", [
    (["--paged", "--prefix-cache", "--prefill", "whole"], "incompatible with --prefill whole"),
    (["--paged", "--spec-draft-plan", "w2a2", "--prefill", "whole"],
     "incompatible with --prefill whole"),
    (["--spec-draft-plan", "w2a2"], "--spec-draft-plan requires --paged"),
    (["--temperature", "0.7"], "requires --paged"),
    (["--paged", "--spec-draft-plan", "w9a9"], "not a known plan"),
    (["--paged", "--spec-k", "0"], "--spec-k must be >= 1"),
    (["--paged", "--temperature", "-1"], "--temperature must be >= 0"),
    (["--paged", "--top-p", "0"], "--top-p must be in"),
    (["--paged", "--top-k", "-1"], "--top-k must be >= 0"),
    (["--paged", "--ring"], "--ring requires a sliding-window arch"),
    (["--paged", "--ring", "--arch", "moonshot-v1-16b-a3b"],
     "--ring requires a sliding-window arch"),
    (["--paged", "--ring", "--prefix-cache", "--arch", "gemma3-12b"],
     "--ring is incompatible with --prefix-cache"),
    (["--ring", "--arch", "gemma3-12b"], "--ring requires --paged"),
    (["--trace-out", "t.json"], "--trace-out requires --paged"),
    (["--a-scale", "static"], "requires an activation-quantized plan"),
    (["--plan", "legacy", "--a-scale", "static"], "incompatible with --plan legacy")])
def test_serve_rejects_the_references_incompatible_combinations(flags, msg):
    args = serve.build_parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", *flags])
    with pytest.raises(ValueError, match=msg):
        serve.validate_args(args)


@pytest.mark.parametrize("flags,msg", [
    (["--nonuniform", "--plan", "w2a8_bs"], "incompatible with a bit-sliced plan"),
    (["--nonuniform", "--group-size", "64"], "incompatible with group-wise scales"),
    (["--nonuniform", "--plan", "mixed_attn4_mlp2"], "incompatible with group-wise"),
    (["--arch", "deepgemm-cnn"], "not a decoder LM")])
def test_serve_rejects_the_ports_own_combinations(flags, msg):
    """The port's own rules: --nonuniform reaches a preset's policies, so
    it refuses the presets it cannot serve; the CNN is not served here."""
    args = serve.build_parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", *flags])
    with pytest.raises(ValueError, match=msg):
        serve.validate_args(args)


def test_serve_without_a_card_and_without_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--paged"])
