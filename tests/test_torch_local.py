"""The port's local (sliding-window) attention against the JAX reference,
on the reference's reduced configs of gemma3-12b (6 layers: 5 local of
window 16, 1 global; GeGLU; 4 heads over 2 KV heads, hd 16) and
h2o-danube-3-4b (one local layer of window 16), float32, every input from
a numpy seed and JAX's weights carried across with the bridge: the
configs, the bridge and one forward past the window, GeGLU against the
reference's ``mlp_apply``, the windowed attention oracles against the
reference's masked jnp decode on the same gathered view, the kernels'
torch walks against the plain versions at hd 120 and 256 with and without
a window, the paged engine's greedy tokens against the reference's
``Engine`` (int8 pool, prompts past the window, also under the prefix
cache), and the fixed-batch loop's tokens against the reference's loop
over a local ring that wraps.

Tolerances: float32 forwards and logits within 1e-4 of max|logit| (two
frameworks' summation orders and transcendental ulps; the cacheless
prefill groups the heads through ``kv_repeat`` as the reference does, so
the grouping is the same and only the order of each f32 dot product may
differ); GeGLU bit-identical in bfloat16 against the reference run eagerly
(every op rounded in bf16 by both) and within 1e-6 relative in float32;
attention oracles within 2e-4 (the reference's own kernel tests'); the
walks within 1e-5 of max|plain| (another f32 summation order); prefix-cache
and engine tokens identical, or a divergence only where the reference's
top-2 logit margin is below MARGIN_TOL.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduce_for_smoke as jreduce
from repro.core import qplan as jqplan
from repro.launch import steps as jsteps
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.serving import Engine as JEngine, Request as JRequest
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import qplan
from repro_torch.kernels import kv_cache_attention as KA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels.ref import ref_kv_cache_attention
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving import Engine, Request

KEY = jax.random.PRNGKey(0)
ARCHS = ("gemma3-12b", "h2o-danube-3-4b")
LOGIT_TOL = 1e-4
ATTN_TOL = 2e-4
WALK_TOL = 1e-5
MARGIN_TOL = 1e-3
WINDOW = 16                        # the reduced configs' window
PROMPT_LENS = (5, 21, 37, 30)      # three past the window
MAX_NEW = 6
ENGINE_KW = dict(n_slots=2, max_len=64, block_size=8, chunk_size=16)
B, P, GEN = 2, 20, 6               # the fixed loop: a ring of 16 rows wraps

_CACHE = {}


def _setup(arch: str, kv: str = "int8"):
    """Reduced float32 configs of ``arch`` under w2a16 with a ``kv`` cache on
    both sides, the reference's plain and packed trees, and the port's."""
    key = (arch, kv)
    if key not in _CACHE:
        jc = dataclasses.replace(jreduce(jget_config(arch)), dtype="float32",
                                 kv_cache_dtype=kv,
                                 quant=jqplan.make_plan(w_bits=2, backend="ref"))
        tc = dataclasses.replace(reduce_for_smoke(get_config(arch)), dtype="float32",
                                 kv_cache_dtype=kv, quant=qplan.make_plan(w_bits=2))
        params = jlm.init_params(KEY, jc)
        qp = jlm.quantize_tree(params, jc)
        tq = bridge.qparams_from_jax(jax.tree.map(np.asarray, qp), tc, device="cpu")
        _CACHE[key] = (jc, tc, params, qp, tq)
    return _CACHE[key]


def _close_logits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Every field the port reads, full width and reduced."""
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
              "hd", "pattern", "window", "kv_repeat", "rope_theta", "mlp", "norm",
              "tie_embeddings", "kv_cache_dtype", "qkv_bias")
    for jc, tc in ((jget_config(arch), get_config(arch)),
                   (jreduce(jget_config(arch)), reduce_for_smoke(get_config(arch)))):
        assert {f: getattr(tc, f) for f in fields} == {f: getattr(jc, f) for f in fields}
        assert tc.layer_types() == tuple(jc.pattern[i % len(jc.pattern)]
                                         for i in range(jc.n_layers))
    assert reduce_for_smoke(get_config(arch)).window == WINDOW


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_forward_past_the_window(arch):
    """The plain tree carried across (gemma3: one superblock of 6 layers with
    GeGLU's w_gate), then one cacheless forward of 40 tokens, past the
    16-row window, against the reference's jitted forward."""
    jc, tc, params, _, _ = _setup(arch)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    assert len(tp["layers"]) == tc.n_layers
    assert tc.layer_types() == (("local",) * 5 + ("global",) if arch == "gemma3-12b"
                                else ("local",))
    wg = np.asarray(params["blocks"]["l0"]["mlp"]["w_gate"]["w"][0])
    np.testing.assert_array_equal(tp["layers"][0]["mlp"]["w_gate"]["w"].numpy(), wg)
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size, size=(2, 40))
    jh, _ = jlm.forward(params, jc, jnp.asarray(tokens, jnp.int32))
    th, _ = lm.forward(tp, tc, torch.from_numpy(tokens))
    _close_logits(lm.logits_fn(tp, tc, th), jlm.logits_fn(params, jc, jh))
    # the window is live: the same forward with every layer global differs
    tg = dataclasses.replace(tc, pattern=("global",))
    tg_h, _ = lm.forward(tp, tg, torch.from_numpy(tokens))
    assert not torch.allclose(tg_h[:, WINDOW:], th[:, WINDOW:], atol=1e-3)
    torch.testing.assert_close(tg_h[:, :WINDOW], th[:, :WINDOW])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_matches_reference_mlp(dtype):
    jc = dataclasses.replace(jreduce(jget_config("gemma3-12b")), dtype=dtype)
    tc = dataclasses.replace(reduce_for_smoke(get_config("gemma3-12b")), dtype=dtype)
    p = jL.mlp_init(KEY, jc, mode="plain", dtype=jnp.dtype(dtype))
    x = jnp.asarray(np.random.default_rng(3).normal(size=(2, 7, jc.d_model)) * 2.0,
                    jnp.dtype(dtype))
    with jax.disable_jit():                      # op by op, as the port rounds
        want = jL.mlp_apply(p, x, cfg=jc)
    tp = jax.tree.map(lambda a: bridge.to_torch(np.asarray(a), "cpu"), p)
    got = L.mlp_apply(tp, bridge.to_torch(np.asarray(x), "cpu"), cfg=tc)
    w = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), w)
    else:
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())


def _pool(rng, *, B, KV, hd, bits, bs, lengths):
    need = [-(-n // bs) for n in lengths]
    nb = max(need) + 1
    n_blocks = 1 + sum(need)
    ids = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, nb), np.int64)
    o = 0
    for b, k in enumerate(need):
        tables[b, :k] = ids[o:o + k]
        o += k
    shape = (n_blocks, bs, KV, hd * bits // 8)

    def codes():
        if bits == 8:
            return rng.integers(-127, 128, size=shape).astype(np.int8)
        return rng.integers(0, 256, size=shape).astype(np.uint8)

    ops = [rng.normal(size=(B, KV, 2, hd)).astype(np.float32), codes(),
           rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32), codes(),
           rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32), tables,
           np.asarray(lengths, np.int64)]
    return [torch.from_numpy(x) for x in ops]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window", [WINDOW, 5, 100])
def test_windowed_oracles_match_reference_masked_decode(bits, window):
    """The three oracles with a window against the reference's jnp decode
    (``decode_attention`` with its local mask, layers.py:589-591) on the
    same gathered, dequantized view."""
    rng = np.random.default_rng(window + bits)
    lengths = (40, 9, 23)
    ops = _pool(rng, B=3, KV=2, hd=16, bits=bits, bs=8, lengths=lengths)
    q, kp, ks, vp, vs, tbl, lens = ops
    n, nb = kp.shape[1], tbl.shape[1]

    def view(pool, sc):
        g = PA.dequant_kv_tile(pool[tbl], sc[tbl], bits)
        return g.reshape(3, nb * n, 2, 16).numpy()

    pos = lens.numpy() - 1
    idx = np.arange(nb * n)[None, :]
    valid = (idx <= pos[:, None]) & (idx > pos[:, None] - window)
    want = np.asarray(jL.decode_attention(jnp.asarray(q.numpy())[:, None],
                                          jnp.asarray(view(kp, ks)),
                                          jnp.asarray(view(vp, vs)),
                                          jnp.asarray(valid)))[:, 0]
    kd, vd = view(kp, ks), view(vp, vs)
    got = {"paged": PA.paged_attention_plain(*ops, bits=bits, window=window),
           "split": PA.paged_attention_splitkv_plain(*ops, bits=bits, kv_splits=3,
                                                     window=window),
           "dense": ref_kv_cache_attention(
               q, torch.from_numpy(kd), torch.ones(kd.shape[:3]), torch.from_numpy(vd),
               torch.ones(vd.shape[:3]), lens, 8, window)}
    for name, g in got.items():       # "dense": the view's f32 values, unit scales
        np.testing.assert_allclose(g.numpy(), want, rtol=ATTN_TOL, atol=ATTN_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("hd,bits", [(120, 8), (256, 8), (256, 4)])
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("kv_splits", [1, 3])
def test_paged_walk_matches_plain_at_new_head_dims(hd, bits, window, kv_splits):
    """The paged kernels' torch walk (tiles from the window's tile, the rows
    below it masked; chunks wholly below it empty) against the oracle."""
    rng = np.random.default_rng(hd + (window or 0) + kv_splits)
    ops = _pool(rng, B=2, KV=2, hd=hd, bits=bits, bs=16, lengths=(300, 45))
    got = PA.paged_attention_walk(*ops, bits=bits, kv_splits=kv_splits, window=window)
    want = PA.paged_attention_plain(*ops, bits=bits, window=window)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=WALK_TOL * want.abs().max().item())


@pytest.mark.parametrize("hd,bits", [(120, 8), (256, 8), (256, 4)])
def test_kv_cache_walk_matches_oracle_at_new_head_dims(hd, bits):
    """The dense cache's replay (hd 120 run as 128 with zero pad dims; hd
    256 with one PV token group) against the oracle, on a full ring (length
    W) and a filling one."""
    rng = np.random.default_rng(hd * bits)
    S = 160
    shape = (2, S, 2, hd * bits // 8)

    def codes():
        if bits == 8:
            return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))
        return torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.uint8))

    def scales():
        return torch.from_numpy(rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32))

    q = torch.from_numpy(rng.normal(size=(2, 2, 4, hd)).astype(np.float32))
    ops = (q, codes(), scales(), codes(), scales(), torch.tensor([S, 37]))
    got = KA.kv_cache_attention_walk(*ops, bits=bits)
    want = ref_kv_cache_attention(*ops, bits)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=WALK_TOL * want.abs().max().item())


@pytest.mark.parametrize("heads", [1, 8, 16, 32, 40, 64, 132, 200])
def test_wide_head_clusters_fit_in_one_wave(heads):
    """At hd 256 (one block an SM) the single passes take the largest cluster
    of at most WIDE_MAX_CLUSTER ranks whose ``heads`` clusters the card holds
    at once (``WIDE_RESIDENT``), whole tiles a rank; at hd 120 the rule of
    the head dims up to 128 (``kernel_head_dim`` 128)."""
    for extent in (48, 1151, 8192, 32768):
        C, rows = PA.cluster_ranks(extent, 1, heads, 2, unit=16, hd=256)
        assert 1 <= C <= PA.WIDE_MAX_CLUSTER and C * rows >= extent > (C - 1) * rows
        assert rows % PA.KERNEL_TILE == 0
        assert C == 1 or PA.WIDE_RESIDENT[C - 1] >= heads
        fit = max([c for c in range(1, PA.WIDE_MAX_CLUSTER + 1)
                   if PA.WIDE_RESIDENT[c - 1] >= heads], default=1)
        tiles = -(-extent // PA.KERNEL_TILE)
        assert C <= max(1, min(fit, tiles // PA.MIN_RANK_TILES))
        assert PA.cluster_ranks(extent, 1, heads, 2, unit=16, hd=120) == \
            PA.cluster_ranks(extent, 1, heads, 2, unit=16, hd=128)
    assert PA.kernel_head_dim(120) == 128 and PA.kernel_head_dim(256) == 256


def _prompts(jc, shared: int = 0):
    rng = np.random.default_rng(1)
    head = rng.integers(0, jc.vocab_size, size=shared)
    return [np.concatenate([head, rng.integers(0, jc.vocab_size, size=n)]).astype(np.int32)
            for n in PROMPT_LENS]


def _run_jax_engine(jc, qp, prompts, **kw):
    eng = JEngine(jc, qp, **{**ENGINE_KW, **kw})
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
    return [r.out for r in reqs], margins


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


@pytest.mark.parametrize("arch,prefix_cache", [("gemma3-12b", False),
                                               ("gemma3-12b", True),
                                               ("h2o-danube-3-4b", False)])
def test_paged_engine_matches_reference_past_the_window(arch, prefix_cache):
    """Greedy tokens through the paged engine on an int8 pool, prompts past
    the window: every decode step's local layers through the windowed
    ``paged_attention`` op (its plain version here), the chunked prefill
    through the windowed mask. Under the prefix cache the prompts share a
    16-token head (two blocks)."""
    jc, tc, _, qp, tq = _setup(arch)
    prompts = _prompts(jc, shared=16 if prefix_cache else 0)
    want, margins = _run_jax_engine(jc, qp, prompts, prefix_cache=prefix_cache)
    eng = Engine(tc, tq, **ENGINE_KW, prefix_cache=prefix_cache)
    assert eng.layer_kv_splits == (1,) * tc.n_layers
    reqs = [Request(uid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    with obs_metrics.scoped(isolate=True) as reg:
        m = eng.run()
    _same_or_near_tie(want, [r.out for r in reqs], margins)
    n_local = tc.layer_types().count("local")
    assert n_local >= 1
    assert reg.counter_total("kernel_dispatch_total", op="paged_attention") == \
        tc.n_layers * m["decode_steps"]
    if prefix_cache:
        assert m["prefill_tokens_shared"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_fixed_loop_matches_reference_over_a_wrapped_ring(arch):
    """The fixed-batch loop: a 20-token prompt folded into each local
    layer's 16-row ring, then 5 decode steps that keep wrapping it, through
    ``kv_cache_attention`` (its plain version, the kernel's replay) with
    lengths min(pos + 1, 16); tokens and the first two steps' logits against
    the reference's loop."""
    jc, tc, _, qp, tq = _setup(arch)
    tokens = np.random.default_rng(4).integers(0, jc.vocab_size, size=(B, P)).astype(np.int32)
    jpre = jax.jit(jsteps.make_prefill_step(jc, max_len=P + GEN))
    jdec = jax.jit(jsteps.make_decode_step(jc))
    logits, caches = jpre(qp, {"tokens": jnp.asarray(tokens)})
    want, want_logits = [jnp.argmax(logits[:, -1], -1)], [np.asarray(logits)]
    for i in range(GEN - 1):
        logits, caches = jdec(qp, caches, {"tokens": want[-1][:, None],
                                           "pos": jnp.full((B,), P + i, jnp.int32)})
        want.append(jnp.argmax(logits[:, -1], -1))
        want_logits.append(np.asarray(logits))
    want = np.stack([np.asarray(t) for t in want], 1)

    prefill = steps.make_prefill_step(tc, max_len=P + GEN)
    decode = steps.make_decode_step(tc)
    with obs_metrics.scoped(isolate=True) as reg:
        lg, tcache = prefill(tq, {"tokens": torch.from_numpy(tokens).long()})
        rows = [c["k"].shape[1] for c in tcache]
        assert rows == [WINDOW if t == "local" else P + GEN for t in tc.layer_types()]
        got, got_logits = [lg[:, -1].argmax(-1)], [lg.numpy()]
        for i in range(GEN - 1):
            lg, tcache = decode(tq, tcache, {"tokens": got[-1][:, None],
                                             "pos": torch.full((B,), P + i)})
            got.append(lg[:, -1].argmax(-1))
            got_logits.append(lg.numpy())
    got = torch.stack(got, 1).numpy()
    for b in range(B):
        if not (want[b] == got[b]).all():
            step = int(np.argmax(want[b] != got[b]))
            top = np.sort(want_logits[step][b, -1])[-2:]
            assert top[1] - top[0] < MARGIN_TOL, (b, step, want[b], got[b])
    _close_logits(got_logits[0], want_logits[0])
    _close_logits(got_logits[1], want_logits[1])
    assert reg.counter_total("kernel_dispatch_total", op="kv_cache_attention") == \
        tc.n_layers * (GEN - 1)


def test_prefill_to_cache_folds_local_layers_like_reference():
    """Each local layer's prompt K/V folded into its ring (slot t % W, the
    last W rows, quantized after the fold), element by element against the
    reference's ``prefill_to_cache``, for a prompt past the window and one
    inside it."""
    jc, tc, *_ = _setup("gemma3-12b")
    rng = np.random.default_rng(6)
    for plen in (37, 9):
        kv_np = [{n: rng.normal(size=(B, plen, tc.n_kv_heads, tc.hd)).astype(np.float32)
                  for n in ("k", "v")} for _ in range(tc.n_layers)]
        jtree = {"blocks": {f"l{j}": {"attn": {n: jnp.asarray(kv_np[j][n])[None]
                                               for n in ("k", "v")}}
                            for j in range(tc.n_layers)}}
        want = jlm.prefill_to_cache(jc, jtree, plen, plen + GEN)
        want = bridge.cache_from_jax(jax.tree.map(np.asarray, want), tc, device="cpu")
        got = lm.prefill_to_cache(tc, [{n: torch.from_numpy(a) for n, a in layer.items()}
                                       for layer in kv_np], plen, plen + GEN)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for name in g:
                assert g[name].shape == w[name].shape
                if name.endswith("_sc"):
                    np.testing.assert_array_max_ulp(g[name].numpy(), w[name].numpy(),
                                                    maxulp=1)
                else:
                    assert torch.equal(g[name], w[name])
