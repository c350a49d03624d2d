"""The port's recurrent families against the JAX reference, on the
reference's reduced configs of recurrentgemma-9b (4 layers: RG-LRU,
RG-LRU, local attention of window 16 with 4 query heads over 1 KV head,
RG-LRU; d_rnn 64, GeGLU) and rwkv6-1.6b (2 RWKV6 layers of 4 heads of 16),
float32, every input from a numpy seed and JAX's weights carried across
with the bridge: the configs, the associative scan's replay, the RG-LRU
and RWKV6 blocks (both WKV branches), the whole reduced forwards under
the bf16 plan and w2a16, the paged engine (first tokens, a preemption,
state isolation between slots), the fixed-batch loop, and the serve
CLI's refusals.

Tolerances (stated):
- ``associative_scan`` against ``jax.lax.associative_scan`` (eager):
  bit for bit (the same pairs combined in the same order, each product and
  sum rounded on its own);
- RG-LRU blocks: within 1e-6 of max|h| and of max|out|. XLA on the CPU
  computes exp, log1p, sqrt and the sigmoid to within an ulp or two of
  torch's, not bit for bit (measured: 9% of f32 exps differ in the last
  ulp), so the gates differ in their last ulps before the bitwise scan;
- RWKV6 blocks: within RWKV_TOL of max|out| (the WKV's f32 einsums and the
  group norm's means sum in another order), and the port's
  ``wkv_chunked`` within 1e-4 of ``wkv_scan`` (the reference's own
  chunked-vs-scan tolerance, tests/test_models_smoke.py);
- whole reduced forwards and the fixed loop's logits: within 1e-4 of
  max|logit|;
- engine and fixed-loop tokens: identical, or a divergence only where the
  reference's top-2 logit margin is below MARGIN_TOL; the first token of
  every request identical, as the reference's
  ``test_engine_recurrent_arch_completes`` asserts.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduce_for_smoke as jreduce
from repro.core import qplan as jqplan
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import recurrent as JR
from repro.serving import Engine as JEngine, Request as JRequest
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import qplan
from repro_torch.kernels import kv_cache_attention as KA
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch import serve, steps
from repro_torch.models import lm
from repro_torch.models import recurrent as R
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving import Engine, Request

KEY = jax.random.PRNGKey(0)
ARCHS = ("recurrentgemma-9b", "rwkv6-1.6b")
RWKV_LAYERS = 2
H_TOL = 1e-6
RWKV_TOL = 1e-5
LOGIT_TOL = 1e-4
MARGIN_TOL = 1e-3
ENGINE_KW = dict(n_slots=2, max_len=64, block_size=8, chunk_size=8)
B, P, GEN = 2, 20, 6

_CACHE = {}


def _configs(arch: str, plan: str = "w2a16"):
    """Reduced float32 configs of ``arch`` on both sides (rwkv6 at
    RWKV_LAYERS layers), int8 KV where there is attention, under w2a16
    (``plan`` "bf16": unquantized)."""
    jc = jreduce(jget_config(arch))
    tc = reduce_for_smoke(get_config(arch))
    extra = {"n_layers": RWKV_LAYERS} if arch == "rwkv6-1.6b" else {}
    jq = jqplan.PLANS["bf16"] if plan == "bf16" else jqplan.make_plan(w_bits=2,
                                                                     backend="ref")
    tq = qplan.PLANS["bf16"] if plan == "bf16" else qplan.make_plan(w_bits=2)
    jc = dataclasses.replace(jc, dtype="float32", kv_cache_dtype="int8", quant=jq, **extra)
    tc = dataclasses.replace(tc, dtype="float32", kv_cache_dtype="int8", quant=tq, **extra)
    return jc, tc


def _reference_tree(tp: dict, jc) -> dict:
    """The port's plain tree laid out as the reference's: the layers of the
    superblocks stacked under ``blocks`` (l<j>: every superblock's layer
    j), the remainder under ``rem``."""
    def to(t):
        return jnp.asarray(t.numpy())

    tree = {k: jax.tree.map(to, v) for k, v in tp.items() if k != "layers"}
    layers = [jax.tree.map(to, layer) for layer in tp["layers"]]
    L, n_sb = len(jc.pattern), jc.n_superblocks
    if n_sb:
        tree["blocks"] = {f"l{j}": jax.tree.map(lambda *xs: jnp.stack(xs),
                                                *layers[j:n_sb * L:L])
                          for j in range(L)}
    if jc.n_remainder:
        tree["rem"] = {f"r{i}": layers[n_sb * L + i] for i in range(jc.n_remainder)}
    return tree


def _setup(arch: str, plan: str = "w2a16"):
    """The configs, the reference's tree (plain, or packed under w2a16 by
    its ``quantize_tree``) and the port's of the same weights. The plain
    weights are the port's ``init_params`` from a seeded generator (the
    reference's distributions, drawn once an arch), laid out as the
    reference's; the port's tree is carried back across by the bridge."""
    key = (arch, plan)
    if key not in _CACHE:
        jc, tc = _configs(arch, plan)
        if arch not in _CACHE:
            _CACHE[arch] = _reference_tree(
                lm.init_params(tc, torch.Generator().manual_seed(0), "cpu"), jc)
        tree = _CACHE[arch]
        if plan != "bf16":
            tree = jax.jit(functools.partial(jlm.quantize_tree, cfg=jc))(tree)
        tp = bridge.qparams_from_jax(jax.tree.map(np.asarray, tree), tc, device="cpu")
        _CACHE[key] = (jc, tc, tree, tp)
    return _CACHE[key]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Every field the port reads, full width and reduced, and the layer
    types (recurrentgemma: 12 x (rec, rec, local) + 2 rec)."""
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "hd", "pattern", "window", "kv_repeat", "rope_theta",
              "mlp", "norm", "tie_embeddings", "kv_cache_dtype", "d_rnn", "conv_width",
              "rwkv_head_size", "source")
    for jc, tc in ((jget_config(arch), get_config(arch)),
                   (jreduce(jget_config(arch)), reduce_for_smoke(get_config(arch)))):
        assert {f: getattr(tc, f) for f in fields} == {f: getattr(jc, f) for f in fields}
        assert tc.layer_types() == jc.layer_types
    full = get_config(arch)
    if arch == "recurrentgemma-9b":
        assert full.layer_types().count("local") == 12 and full.n_heads // full.n_kv_heads == 16
        assert full.attention_layers() == tuple(range(2, 36, 3))
    else:
        assert full.attention_layers() == () and full.has_state


@pytest.mark.parametrize("S", [7, 32])
def test_associative_scan_replays_jax_bit_for_bit(S):
    """h_t = a_t h_{t-1} + b_t through the replay of
    ``jax.lax.associative_scan``'s recursion, against the reference's
    combine run by JAX eagerly (its rglru_apply's scan): an odd length (7:
    an odd level at every depth) and a power of two (32). Under
    ``jax.jit`` XLA contracts the combine's product and sum into one fused
    multiply-add, so a jitted reference is not the bitwise target."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.3, 1.0, size=(2, S, 24)).astype(np.float32)
    b = rng.normal(size=(2, S, 24)).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = R.associative_scan(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _block(arch: str, name: str):
    """Layer 0's ``name`` block of ``arch`` (plain weights): the configs,
    the reference's params and the port's."""
    jc, tc, tree, tp = _setup(arch, "bf16")
    p = jax.tree.map(lambda x: x[0], tree["blocks"]["l0"][name])
    return jc, tc, p, tp["layers"][0][name]


_RGLRU_REF = jax.jit(JR.rglru_apply, static_argnames="cfg")
_RWKV_REF = jax.jit(JR.rwkv_apply, static_argnames="cfg")


@pytest.mark.parametrize("S", [11, 32])
def test_rglru_matches_reference(S):
    """One RG-LRU block at prefill (S rows from a zero state), then three
    decode steps on the carried state, against ``repro.models.recurrent.
    rglru_apply``: outputs, h and the conv rows."""
    jc, tc, p, tp = _block("recurrentgemma-9b", "rnn")
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S + 3, jc.d_model)).astype(np.float32)
    ref = functools.partial(_RGLRU_REF, cfg=jc)
    want, wst = ref(p, jnp.asarray(x[:, :S]))
    got, gst = R.rglru_apply(tp, _t(x[:, :S]), cfg=tc)
    for t in range(S, S + 3):
        _close(got, want, H_TOL)
        _close(gst["h"], wst["h"], H_TOL)
        np.testing.assert_allclose(gst["conv"].numpy(), np.asarray(wst["conv"]),
                                   rtol=0, atol=H_TOL * np.abs(x).max())
        want, wst = ref(p, jnp.asarray(x[:, t:t + 1]), state=wst)
        got, gst = R.rglru_apply(tp, _t(x[:, t:t + 1]), cfg=tc, state=gst)
    _close(got, want, H_TOL)
    _close(gst["h"], wst["h"], H_TOL)


@pytest.mark.parametrize("S", [11, 64])
def test_rwkv_matches_reference(S):
    """One RWKV6 layer, S rows from a zero state (S 11: ``wkv_scan``; S 64:
    ``wkv_chunked``), then two decode steps on the carried state, against
    ``repro.models.recurrent.rwkv_apply``."""
    jc, tc, p, tp = _block("rwkv6-1.6b", "rwkv")
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S + 2, jc.d_model)).astype(np.float32)
    ref = functools.partial(_RWKV_REF, cfg=jc)
    want, wst = ref(p, jnp.asarray(x[:, :S]))
    got, gst = R.rwkv_apply(tp, _t(x[:, :S]), cfg=tc)
    for t in range(S, S + 2):
        _close(got, want, RWKV_TOL)
        for name in ("s", "shift_t", "shift_c"):
            _close(gst[name], wst[name], RWKV_TOL)
        want, wst = ref(p, jnp.asarray(x[:, t:t + 1]), state=wst)
        got, gst = R.rwkv_apply(tp, _t(x[:, t:t + 1]), cfg=tc, state=gst)
    _close(got, want, RWKV_TOL)
    _close(gst["s"], wst["s"], RWKV_TOL)


def test_wkv_chunked_matches_wkv_scan():
    """The port's block-parallel WKV against its sequential one, from a
    nonzero state, over 2 chunks of 64 (and the scan's fallback off a
    chunk multiple), as the reference's test_rwkv_chunked_matches_scan."""
    rng = np.random.default_rng(5)
    Bq, S, H, hd = 2, 128, 4, 16
    r, k = (_t(rng.normal(size=(Bq, S, H, hd)).astype(np.float32) * 0.5) for _ in range(2))
    v = _t(rng.normal(size=(Bq, S, H, hd)).astype(np.float32))
    w = torch.sigmoid(_t(rng.normal(size=(Bq, S, H, hd)).astype(np.float32)) + 2.0) * 0.3 + 0.69
    u = _t(rng.normal(size=(H, hd)).astype(np.float32) * 0.1)
    s0 = _t(rng.normal(size=(Bq, H, hd, hd)).astype(np.float32) * 0.1)
    o1, s1 = R.wkv_scan(r, k, v, w, u, s0)
    o2, s2 = R.wkv_chunked(r, k, v, w, u, s0)
    torch.testing.assert_close(o2, o1, rtol=0, atol=1e-4)
    torch.testing.assert_close(s2, s1, rtol=0, atol=1e-4)
    o3, s3 = R.wkv_chunked(r[:, :70], k[:, :70], v[:, :70], w[:, :70], u, s0)
    o4, s4 = R.wkv_scan(r[:, :70], k[:, :70], v[:, :70], w[:, :70], u, s0)
    assert torch.equal(o3, o4) and torch.equal(s3, s4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("plan", ["bf16", "w2a16"])
def test_forward_matches_reference(arch, plan):
    """The whole reduced model, cacheless, at 64 tokens (past the window of
    16; RWKV's ``wkv_chunked`` branch), logits against
    ``repro.models.lm.forward``; and the bridge's layout: one port layer
    per reference layer, in ``layer_type`` order."""
    jc, tc, tree, tp = _setup(arch, plan)
    assert len(tp["layers"]) == tc.n_layers
    if plan == "bf16":             # the bridge gives the drawn tree back
        drawn = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(drawn),
                                                     jax.tree.leaves(tp)))
    mixers = {"rnn": "recurrent", "rwkv": "rwkv", "attn": "local"}
    assert tuple(next(t for k, t in mixers.items() if k in layer)
                 for layer in tp["layers"]) == tc.layer_types()
    tokens = np.random.default_rng(7).integers(0, jc.vocab_size, size=(2, 64))
    want = jax.jit(lambda p, t: jlm.logits_fn(p, jc, jlm.forward(p, jc, t)[0]))(
        tree, jnp.asarray(tokens, jnp.int32))
    th, _ = lm.forward(tp, tc, torch.from_numpy(tokens))
    _close(lm.logits_fn(tp, tc, th), want, LOGIT_TOL)


def _prompts(vocab: int, lens, seed: int = 1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _margins_sampler(eng, margins):
    def greedy(logits, *_):
        lg = np.asarray(logits)
        for i, s in enumerate(eng.slots):
            if s.state == jengine._DECODE:
                top = np.sort(lg[i])[-2:]
                margins[(s.req.uid, len(s.req.out))] = float(top[1] - top[0])
        return jnp.argmax(logits, axis=-1)
    return greedy


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


def test_paged_engine_matches_reference_with_a_preemption():
    """Two requests of 14 tokens (priorities 1 and 0) through the paged
    engine in a pool of 5 usable 8-row blocks, chunks of 8 (the second
    chunk exact-length): the low-priority request is preempted and
    re-prefilled from a zero state, as in the reference's
    test_block_exhaustion_preempts_requeues_completes. The first tokens
    equal the reference engine's; every token too, or a divergence only
    at a near tie; the preemption counts match; the local layer decodes
    through ``paged_attention`` (its plain version)."""
    jc, tc, tree, tp = _setup("recurrentgemma-9b")
    prompts = _prompts(jc.vocab_size, (14, 14), seed=2)
    kw = dict(ENGINE_KW, n_blocks=6)
    jeng = JEngine(jc, tree, **kw)
    margins: dict = {}
    jeng._sample = _margins_sampler(jeng, margins)
    jreqs = [JRequest(uid=i, prompt=p, max_new=12, priority=1 - i)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        assert jeng.submit(r)
    jm = jeng.run()
    eng = Engine(tc, tp, **kw)
    assert eng.prefill_batch == 1 and eng.radix is None
    reqs = [Request(uid=i, prompt=p, max_new=12, priority=1 - i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    with obs_metrics.scoped(isolate=True) as reg:
        m = eng.run()
    assert all(r.done and len(r.out) == 12 for r in reqs)
    assert [r.out[0] for r in reqs] == [r.out[0] for r in jreqs]
    _same_or_near_tie([r.out for r in jreqs], [r.out for r in reqs], margins)
    assert m["preemptions"] == jm["preemptions"] >= 1
    assert [r.n_preempted for r in reqs] == [r.n_preempted for r in jreqs]
    assert eng.pool.n_free == eng.n_blocks - 1
    n_attn = len(tc.attention_layers())
    assert reg.counter_total("kernel_dispatch_total", op="paged_attention") == \
        n_attn * m["decode_steps"]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_state_is_per_slot(arch):
    """A request's tokens alone equal its tokens beside two others in the
    same 3-slot engine (other slots' prefill chunks and decode rows leave
    its state alone), under chunked and whole-prompt prefill; a whole
    prompt equals the chunked run's first token."""
    jc, tc, tree, tp = _setup(arch)
    prompts = _prompts(jc.vocab_size, (13, 5, 21), seed=3)
    kw = dict(ENGINE_KW, n_slots=3)

    def run(ps, **extra):
        eng = Engine(tc, tp, **kw, **extra)
        reqs = [Request(uid=i, prompt=p, max_new=6) for i, p in enumerate(ps)]
        for r in reqs:
            assert eng.submit(r)
        eng.run()
        return [r.out for r in reqs]

    alone = run(prompts[:1])[0]
    assert run(prompts)[0] == alone
    whole = run(prompts, prefill="whole")
    assert whole[0] == run(prompts[:1], prefill="whole")[0]
    assert whole[0][0] == alone[0]


def test_ring_engine_gives_the_table_engines_tokens():
    """recurrentgemma's local layer ring-paged (``Engine(ring=True)``)
    beside its RG-LRU states: prompts past the window of 16, the same
    tokens as the engine without a ring (the ring's contract: the same
    rows attended in the same order)."""
    jc, tc, tree, tp = _setup("recurrentgemma-9b")
    prompts = _prompts(jc.vocab_size, (21, 37, 9), seed=6)

    def run(**kw):
        eng = Engine(tc, tp, **ENGINE_KW, **kw)
        reqs = [Request(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
        for r in reqs:
            assert eng.submit(r)
        eng.run()
        return [r.out for r in reqs], eng

    want, _ = run()
    got, eng = run(ring=True)
    assert eng.ring_len and got == want


def test_engine_refuses_spec_and_keeps_no_pool_for_rwkv():
    """Spec mode is refused for a recurrent model (the reference's words);
    an rwkv6 engine holds per-slot state and no K/V pool."""
    jc, tc, tree, tp = _setup("rwkv6-1.6b")
    with pytest.raises(NotImplementedError, match="rewind a scan state"):
        Engine(tc, tp, **ENGINE_KW, spec_draft_params=tp)
    eng = Engine(tc, tp, **ENGINE_KW)
    assert tc.has_state
    assert all(set(c) == {"rwkv"} for c in eng.caches)
    assert eng.caches[0]["rwkv"]["s"].shape == (2, 4, 16, 16)
    assert eng.caches[0]["rwkv"]["shift_t"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_fixed_loop_matches_reference(arch):
    """The fixed-batch loop: one batched prefill of 20 tokens whose final
    states ``prefill_to_cache`` carries (recurrentgemma's local ring of 16
    rows wraps), then 5 decode steps; the prefill's states (carried across
    by ``cache_from_jax``) within LOGIT_TOL of the reference's, the layout
    that of ``init_cache``, tokens and the first two steps' logits against
    the reference's loop."""
    jc, tc, tree, tp = _setup(arch)
    tokens = np.random.default_rng(4).integers(0, jc.vocab_size, size=(B, P)).astype(np.int32)
    jpre = jax.jit(jsteps.make_prefill_step(jc, max_len=P + GEN))
    jdec = jax.jit(jsteps.make_decode_step(jc))
    logits, caches = jpre(tree, {"tokens": jnp.asarray(tokens)})
    want_cache = bridge.cache_from_jax(jax.tree.map(np.asarray, caches), tc, device="cpu")
    want, want_logits = [jnp.argmax(logits[:, -1], -1)], [np.asarray(logits)]
    for i in range(GEN - 1):
        logits, caches = jdec(tree, caches, {"tokens": want[-1][:, None],
                                             "pos": jnp.full((B,), P + i, jnp.int32)})
        want.append(jnp.argmax(logits[:, -1], -1))
        want_logits.append(np.asarray(logits))
    want = np.stack([np.asarray(t) for t in want], 1)

    prefill = steps.make_prefill_step(tc, max_len=P + GEN)
    decode = steps.make_decode_step(tc)
    with obs_metrics.scoped(isolate=True) as reg:
        lg, tcache = prefill(tp, {"tokens": torch.from_numpy(tokens).long()})
        init = lm.init_cache(tc, B, P + GEN, device="cpu")
        assert [sorted(c) for c in init] == [sorted(c) for c in tcache] == \
            [sorted(c) for c in want_cache]
        for g, w in zip(tcache, want_cache):
            for key in ("rnn", "rwkv"):
                for name in g.get(key, ()):
                    assert g[key][name].shape == w[key][name].shape
                    _close(g[key][name], w[key][name], LOGIT_TOL)
        got, got_logits = [lg[:, -1].argmax(-1)], [lg.numpy()]
        for i in range(GEN - 1):
            lg, tcache = decode(tp, tcache, {"tokens": got[-1][:, None],
                                             "pos": torch.full((B,), P + i)})
            got.append(lg[:, -1].argmax(-1))
            got_logits.append(lg.numpy())
    got = torch.stack(got, 1).numpy()
    for b in range(B):
        if not (want[b] == got[b]).all():
            step = int(np.argmax(want[b] != got[b]))
            top = np.sort(want_logits[step][b, -1])[-2:]
            assert top[1] - top[0] < MARGIN_TOL, (b, step, want[b], got[b])
    _close(got_logits[0], want_logits[0], LOGIT_TOL)
    _close(got_logits[1], want_logits[1], LOGIT_TOL)
    assert reg.counter_total("kernel_dispatch_total", op="kv_cache_attention") == \
        len(tc.attention_layers()) * (GEN - 1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("flags,match", [
    (["--paged", "--prefix-cache"], "--prefix-cache is incompatible with recurrent arch"),
    (["--paged", "--spec-draft-plan", "w2a2"],
     "--spec-draft-plan is incompatible with recurrent arch"),
    (["--paged", "--kv-splits", "4"], "--kv-splits is incompatible with recurrent arch"),
    (["--paged", "--tp", "2"], "recurrent arch .* ROADMAP queue 1, item 11")])
def test_serve_refuses_recurrent_flags(arch, flags, match):
    """The reference's refusals for a recurrent arch (its
    tests/test_serve_flags.py), and ``--tp`` > 1 (ROADMAP item 11)."""
    args = serve.build_parser().parse_args(["--arch", arch, "--smoke", "--device",
                                            "cpu", *flags])
    with pytest.raises(ValueError, match=match):
        serve.validate_args(args)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke(arch, capsys):
    """``python -m repro_torch.launch.serve --arch ARCH --smoke --paged
    --device cpu --plan w2a2`` in process: every request completes, and
    every planned projection dispatches ``lut_gemm`` (6 a recurrentgemma
    RG-LRU layer, 7 a local layer, 8 an rwkv layer, per forward)."""
    assert serve.main(["--arch", arch, "--smoke", "--paged", "--device", "cpu",
                       "--plan", "w2a2", "--requests", "3", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "3/3 requests" in out and "lut_gemm:ref" in out


def test_attention_walks_take_g16_at_hd256():
    """recurrentgemma's head (KV 1, G 16, hd 256) through the kernels' torch
    walks against their plain versions: the paged single pass with a
    window (row 5) and the dense ring's replay (row 9) against the
    reference-math oracle; the wrappers' G limits."""
    rng = np.random.default_rng(9)
    q = _t(rng.normal(size=(2, 1, 16, 256)).astype(np.float32))
    n_blocks, bs = 12, 16
    kp, vp = (_t(rng.integers(-127, 128, size=(n_blocks, bs, 1, 256)).astype(np.int8))
              for _ in range(2))
    ks, vs = (_t(rng.uniform(0.005, 0.05, size=(n_blocks, bs, 1)).astype(np.float32))
              for _ in range(2))
    tables = torch.tensor([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]])
    lengths = torch.tensor([70, 41])
    for window in (None, 32):
        walk = PA.paged_attention_walk(q, kp, ks, vp, vs, tables, lengths, bits=8,
                                       window=window)
        plain = PA.paged_attention_plain(q, kp, ks, vp, vs, tables, lengths, bits=8,
                                         window=window)
        _close(walk, plain, 1e-5)
    dk, dv = kp[1:9].reshape(2, 64, 1, 256), vp[1:9].reshape(2, 64, 1, 256)
    dks, dvs = ks[1:9].reshape(2, 64, 1), vs[1:9].reshape(2, 64, 1)
    lens = torch.tensor([64, 23])
    walk = KA.kv_cache_attention_walk(q, dk, dks, dv, dvs, lens, bits=8)
    plain = PA.paged_attention_plain(q, kp, ks, vp, vs, torch.tensor(
        [[1, 2, 3, 4], [5, 6, 7, 8]]), lens, bits=8)
    _close(walk, plain, 1e-5)
    assert PA.kernel_max_g(256) == 16 and PA.kernel_max_g(128) == 8
    assert PA.kernel_max_g(256, split=True) == 8
