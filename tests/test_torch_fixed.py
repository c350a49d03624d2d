"""The port's fixed-batch serve loop against the JAX reference's: the same
numpy tokens and the same weights (carried across with the bridge) give
the same greedy tokens and first-step logits, on the float32 reduced
qwen1.5-0.5b (two layers) under w2a2 and w2a16 with a bfloat16, int8 and
int4 dense slot cache, and on the reduced moonshot-v1-16b-a3b under w2a2.
Also: ``prefill_to_cache`` and ``bridge.cache_from_jax`` element by
element, one decode step from the reference's own cache, the
``kv_cache_attention`` plain version and walk against the reference's
Pallas kernel (interpret mode) and oracle, the serve CLI without
``--paged``, its "requires --paged" rules, and the no-fallback rule.

Tolerances: logits within 1e-4 of max|logit| (float32 through two
frameworks' GEMM and softmax orders); attention 2e-4 relative and
absolute, as the reference's own kernel test; scales within 1 ulp. Where
the reference's top-2 logit margin at the first diverging step is below
MARGIN_TOL, the two frameworks' f32 rounding may legitimately pick the
other token: the test then reports the step and the margin instead of
failing.
"""

import dataclasses
import os
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
from repro.kernels import ref as jref
from repro.kernels.kv_cache_attention import kv_cache_attention_pallas
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import qplan
from repro_torch.kernels import kv_cache_attention as KA
from repro_torch.kernels import registry
from repro_torch.kernels.ref import butterfly_sum
from repro_torch.launch import serve, steps
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics

KEY = jax.random.PRNGKey(0)
MARGIN_TOL = 1e-3
LOGIT_TOL = 1e-4
ATTN_TOL = 2e-4
B, P, GEN = 2, 8, 6
PLANS = {"w2a2": dict(w_bits=2, a_bits=2), "w2a16": dict(w_bits=2)}

_CACHE = {}


def _setup(arch: str, plan: str, kv: str):
    """Configs, packed weights on both sides, the prompt tokens and the
    reference's jitted (prefill, decode) steps, built once a config."""
    key = (arch, plan, kv)
    if key not in _CACHE:
        kw = PLANS[plan]
        jc = dataclasses.replace(jreduce(jget_config(arch)), n_layers=2,
                                 dtype="float32", kv_cache_dtype=kv,
                                 quant=jqplan.make_plan(**kw, backend="ref"))
        tc = dataclasses.replace(reduce_for_smoke(get_config(arch)), n_layers=2,
                                 dtype="float32", kv_cache_dtype=kv,
                                 quant=qplan.make_plan(**kw))
        qp = jlm.quantize_tree(jlm.init_params(KEY, jc), jc)
        tq = bridge.qparams_from_jax(jax.tree.map(np.asarray, qp), tc, device="cpu")
        tokens = np.random.default_rng(1).integers(
            0, jc.vocab_size, size=(B, P)).astype(np.int32)
        jstep = (jax.jit(jsteps.make_prefill_step(jc, max_len=P + GEN)),
                 jax.jit(jsteps.make_decode_step(jc)))
        _CACHE[key] = (jc, tc, qp, tq, tokens, jstep)
    return _CACHE[key]


def _run_jax(jstep, qp, tokens):
    """The reference's loop (serve.py:453-480) on ``tokens``: greedy
    tokens (B, GEN) and each step's logits."""
    prefill, decode = jstep
    logits, caches = prefill(qp, {"tokens": jnp.asarray(tokens)})
    out, all_logits = [jnp.argmax(logits[:, -1], -1)], [np.asarray(logits)]
    for i in range(GEN - 1):
        batch = {"tokens": out[-1][:, None], "pos": jnp.full((B,), P + i, jnp.int32)}
        logits, caches = decode(qp, caches, batch)
        out.append(jnp.argmax(logits[:, -1], -1))
        all_logits.append(np.asarray(logits))
    return np.stack([np.asarray(t) for t in out], 1), all_logits


def _run_port(tc, tq, tokens, attn_backend="auto"):
    prefill = steps.make_prefill_step(tc, max_len=P + GEN)
    decode = steps.make_decode_step(tc, attn_backend=attn_backend)
    logits, caches = prefill(tq, {"tokens": torch.from_numpy(tokens).long()})
    out, all_logits = [logits[:, -1].argmax(-1)], [logits.numpy()]
    for i in range(GEN - 1):
        batch = {"tokens": out[-1][:, None],
                 "pos": torch.full((B,), P + i, dtype=torch.int64)}
        logits, caches = decode(tq, caches, batch)
        out.append(logits[:, -1].argmax(-1))
        all_logits.append(logits.numpy())
    return torch.stack(out, 1).numpy(), all_logits, caches


def _same_or_near_tie(want, got, want_logits):
    for b in range(want.shape[0]):
        if (want[b] == got[b]).all():
            continue
        step = int(np.argmax(want[b] != got[b]))
        top = np.sort(want_logits[step][b, -1])[-2:]
        margin = float(top[1] - top[0])
        assert margin < MARGIN_TOL, (
            f"row {b} diverges at step {step} with reference top-2 margin "
            f"{margin} >= {MARGIN_TOL}: {want[b]} vs {got[b]}")
        warnings.warn(f"row {b} diverges at step {step}: reference top-2 "
                      f"margin {margin} < {MARGIN_TOL} (near tie)")


def _close_logits(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def _check_loop(arch, plan, kv):
    _, tc, qp, tq, tokens, jstep = _setup(arch, plan, kv)
    want, want_logits = _run_jax(jstep, qp, tokens)
    with obs_metrics.scoped(isolate=True) as reg:
        got, got_logits, _ = _run_port(tc, tq, tokens)
    _same_or_near_tie(want, got, want_logits)
    _close_logits(got_logits[0], want_logits[0])          # prefill
    _close_logits(got_logits[1], want_logits[1])          # first decode step
    n_attn = reg.counter_total("kernel_dispatch_total", op="kv_cache_attention",
                               backend="ref")
    assert n_attn == (0 if kv == "bfloat16" else tc.n_layers * (GEN - 1))
    return reg


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("plan", ["w2a2", "w2a16"])
def test_fixed_loop_matches_reference_steps(plan, kv):
    reg = _check_loop("qwen1.5-0.5b", plan, kv)
    op = "lut_gemm" if plan == "w2a2" else "dequant_matmul"
    assert reg.counter_total("kernel_dispatch_total", op=op) == 7 * 2 * GEN


def test_fixed_loop_moonshot_matches_reference_steps():
    reg = _check_loop("moonshot-v1-16b-a3b", "w2a2", "int8")
    assert reg.counter_total("kernel_dispatch_total", op="expert_lut_gemm") == 3 * 2 * GEN


def _jax_collected(kv_np: list) -> dict:
    """Per-layer K/V (n_layers x {k, v}) as the reference's collect_cache
    tree: one superblock entry per layer, stacked."""
    return {"blocks": {"l0": {"attn": {
        name: jnp.stack([jnp.asarray(layer[name]) for layer in kv_np])
        for name in ("k", "v")}}}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8", "int4"])
def test_prefill_to_cache_matches_reference(kv, dtype):
    jc, tc, *_ = _setup("qwen1.5-0.5b", "w2a2", kv)
    rng = np.random.default_rng(5)
    KV, hd = tc.n_kv_heads, tc.hd
    kv_np = [{n: rng.normal(size=(B, P, KV, hd)).astype(np.float32)
              for n in ("k", "v")} for _ in range(tc.n_layers)]
    kv_np[0]["k"][1, 3] = 0.0                    # a zero row: the scale floor
    jdt, tdt = jnp.dtype(dtype), lm.torch_dtype(dtype)
    want = jlm.prefill_to_cache(
        jc, jax.tree.map(lambda a: a.astype(jdt), _jax_collected(kv_np)), P, P + GEN)
    want = bridge.cache_from_jax(jax.tree.map(np.asarray, want), tc, device="cpu")
    got = lm.prefill_to_cache(
        tc, [{n: torch.from_numpy(a).to(tdt) for n, a in layer.items()}
             for layer in kv_np], P, P + GEN)
    assert len(got) == len(want) == tc.n_layers
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in g:
            assert g[name].dtype == w[name].dtype and g[name].shape == w[name].shape
            if name.endswith("_sc"):
                np.testing.assert_array_max_ulp(g[name].numpy(), w[name].numpy(),
                                                maxulp=1)
            else:
                assert torch.equal(g[name], w[name])
        if kv != "bfloat16":                     # the zero rows past P
            assert (g["k_sc"][:, P:] == np.float32(1e-8)).all()
    if kv != "bfloat16":
        assert (got[0]["k_sc"][1, 3] == np.float32(1e-8)).all()


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "int4"])
def test_init_cache_matches_reference_layout(kv):
    jc, tc, *_ = _setup("qwen1.5-0.5b", "w2a2", kv)
    want = bridge.cache_from_jax(
        jax.tree.map(np.asarray, jlm.init_cache(jc, B, P + GEN, dtype=jnp.float32)), tc,
        device="cpu")
    got = lm.init_cache(tc, B, P + GEN, device="cpu")
    for g, w in zip(got, want):
        assert {n: (t.dtype, t.shape) for n, t in g.items()} == \
            {n: (t.dtype, t.shape) for n, t in w.items()}
        assert all(torch.equal(g[n], w[n]) for n in g)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_decode_step_from_reference_cache(kv):
    """The reference's prefilled cache carried across bit for bit; one
    port decode step leaves every other row as it was, writes the same
    new-row codes and gives the reference's logits. The new row's scales
    are amax / 127 (or / 7) of K/V computed by the two frameworks' f32
    forwards, so they agree to 1e-5 relative, not bit for bit."""
    _, tc, qp, tq, tokens, (prefill, decode) = _setup("qwen1.5-0.5b", "w2a2", kv)
    logits, jcache = prefill(qp, {"tokens": jnp.asarray(tokens)})
    nxt = np.asarray(jnp.argmax(logits[:, -1], -1))
    batch = {"tokens": jnp.asarray(nxt)[:, None], "pos": jnp.full((B,), P, jnp.int32)}
    tcache = bridge.cache_from_jax(jax.tree.map(np.asarray, jcache), tc, device="cpu")
    want_logits, want_cache = decode(qp, jcache, batch)
    got_logits, tcache = steps.make_decode_step(tc)(
        tq, tcache, {"tokens": torch.from_numpy(nxt.copy()).long()[:, None],
                     "pos": torch.full((B,), P, dtype=torch.int64)})
    want_cache = bridge.cache_from_jax(jax.tree.map(np.asarray, want_cache), tc, device="cpu")
    new = torch.arange(P + GEN) == P
    for g, w in zip(tcache, want_cache):
        for name in g:
            assert torch.equal(g[name][:, ~new], w[name][:, ~new])
        for name in ("k", "v"):
            assert torch.equal(g[name][:, new], w[name][:, new])
        for name in ("k_sc", "v_sc"):
            np.testing.assert_allclose(g[name][:, new].numpy(), w[name][:, new].numpy(),
                                       rtol=1e-5, atol=0)
    _close_logits(got_logits.numpy(), np.asarray(want_logits))


def _cache_operands(seed, *, bits, KV, G, S, lengths, hd=16):
    rng = np.random.default_rng(seed)
    Bn = len(lengths)
    width = hd * bits // 8
    if bits == 8:
        codes = [rng.integers(-127, 128, size=(Bn, S, KV, width)).astype(np.int8)
                 for _ in range(2)]
    else:
        codes = [rng.integers(0, 256, size=(Bn, S, KV, width)).astype(np.uint8)
                 for _ in range(2)]
    scs = [rng.uniform(0.005, 0.05, size=(Bn, S, KV)).astype(np.float32)
           for _ in range(2)]
    q = rng.normal(size=(Bn, KV, G, hd)).astype(np.float32)
    return q, codes[0], scs[0], codes[1], scs[1], np.asarray(lengths, np.int64)


def _t(ops):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in ops]


def _close(got, want, tol=ATTN_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# S where the kernel's cluster split gives C = 2 (600: ranks of 384 rows),
# 3 (800), 8 (2048) and 16 (4096, ranks of 256 rows): B 3, KV 2; the
# last rank of 600 and 800 is ragged
RANK_S = {600: 2, 800: 3, 2048: 8, 4096: 16}


@pytest.mark.parametrize("S", [48, 50, 64, 300, *RANK_S])
@pytest.mark.parametrize("KV,G", [(2, 1), (2, 3)])
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_and_walk_match_reference_kernel_and_oracle(bits, KV, G, S):
    """lengths 1, S // 2 and S, one per sequence (at C > 1 the length 1
    leaves every rank but the first past it, and S // 2 cuts a rank)."""
    assert KA.cluster_ranks(S, 3, KV, G)[0] == RANK_S.get(S, 1)
    ops = _cache_operands(bits + 10 * G + S, bits=bits, KV=KV, G=G, S=S,
                          lengths=(1, S // 2, S))
    oracle = jref.ref_kv_cache_attention(*ops, bits)
    pallas = kv_cache_attention_pallas(*(jnp.asarray(x) for x in ops), bits=bits,
                                       interpret=True)
    got = KA.kv_cache_attention_walk(*_t(ops), bits=bits)
    for want in (oracle, pallas):
        _close(got, want)
    assert KA.kv_cache_attention_plain is KA.kv_cache_attention_walk


def test_walk_length_zero_reads_no_row_and_long_lengths_stop_at_S():
    """The oracle averages every row at length 0; the kernel's walk reads
    none and returns 0. A length above S reads the S rows, as the oracle's
    mask does (the serve loop passes neither)."""
    ops = _cache_operands(9, bits=8, KV=2, G=2, S=20, lengths=(0, 17, 25))
    out = KA.kv_cache_attention_walk(*_t(ops), bits=8)
    assert (out[0] == 0).all()
    oracle = jref.ref_kv_cache_attention(*ops, 8)
    assert np.abs(np.asarray(oracle[0])).max() > 0
    _close(out[1:], np.asarray(oracle)[1:])


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("bits", [8, 4])
def test_walk_rounds_each_product_and_sum_on_its_own(bits, hd):
    """The walk is the kernel's schedule, not just its math: walking tiles
    past a short sequence leaves its result bit for bit as it was, and a
    batch gives each row the bits it gets alone."""
    lengths = (300, 100, 7)
    q, k, ksc, v, vsc, lens = _t(_cache_operands(bits + hd, bits=bits, KV=2, G=3,
                                                 S=300, hd=hd, lengths=lengths))
    whole = KA.kv_cache_attention_walk(q, k, ksc, v, vsc, lens, bits=bits)
    for b, n in enumerate(lengths):
        one = slice(b, b + 1)
        alone = KA.kv_cache_attention_walk(q[one], k[one, :n], ksc[one, :n], v[one, :n],
                                           vsc[one, :n], lens[one], bits=bits)
        assert torch.equal(alone[0], whole[b])


@pytest.mark.parametrize("S", list(RANK_S))
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("bits", [8, 4])
def test_walk_rounds_each_product_and_sum_on_its_own_over_ranks(bits, hd, S):
    """With the rows cut over C > 1 ranks, a batch still gives each row the
    bits it gets alone (at the same S, so the same ranks), and the result
    stays within the stated tolerance of the oracle."""
    lengths = (S, S // 3, 7)
    ops = _cache_operands(bits + hd + S, bits=bits, KV=2, G=3, S=S, hd=hd, lengths=lengths)
    q, k, ksc, v, vsc, lens = _t(ops)
    assert KA.cluster_ranks(S, 1, 2, 3) == KA.cluster_ranks(S, 3, 2, 3)
    whole = KA.kv_cache_attention_walk(q, k, ksc, v, vsc, lens, bits=bits)
    for b in range(len(lengths)):
        one = slice(b, b + 1)
        alone = KA.kv_cache_attention_walk(q[one], k[one], ksc[one], v[one], vsc[one],
                                           lens[one], bits=bits)
        assert torch.equal(alone[0], whole[b])
    _close(whole, jref.ref_kv_cache_attention(*ops, bits))


def _one_block_walk(q, k_packed, k_sc, v_packed, v_sc, lengths, *, bits):
    """The kernel's walk with no rank split: one block over the whole cache,
    normalised at the end. Kept as the oracle of the C = 1 case, which must
    give these bits exactly."""
    B, KV, G, hd = q.shape
    S = k_packed.shape[1]
    f32 = torch.float32
    cpw, T = 64 // bits, KA.KERNEL_TILE
    wpr, R = hd // cpw, KA.KERNEL_THREADS // hd
    scale = float(torch.tensor(1.0 / np.sqrt(hd), dtype=f32))
    pad = (-S) % T
    n = torch.clamp(lengths, 0, S)
    kc, vc = (KA._codes(x, bits) for x in (k_packed, v_packed))
    ksc, vsc = k_sc.to(f32), v_sc.to(f32)
    if pad:
        kc, vc = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in (kc, vc))
        ksc, vsc = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (ksc, vsc))
    qw = q.to(f32).reshape(B, KV, G, wpr, cpw)
    m = torch.full((B, KV, G), -1e30, dtype=f32)
    l = torch.zeros((B, KV, G), dtype=f32)
    acc = torch.zeros((B, KV, G, R, hd), dtype=f32)
    for s0 in range(0, S + pad, T):
        live = (s0 + torch.arange(T))[None, :] < n[:, None]
        kt = kc[:, s0:s0 + T].permute(0, 2, 1, 3).reshape(B, KV, 1, T, wpr, cpw)
        dot = torch.zeros((B, KV, G, T, wpr), dtype=f32)
        for j in range(cpw):
            dot = dot + qw[:, :, :, None, :, j] * kt[..., j]
        sc = butterfly_sum(dot) * ksc[:, s0:s0 + T].transpose(1, 2)[:, :, None] * scale
        sc = torch.where(live[:, None, None], sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.where(live[:, None, None], torch.exp(sc - m_new[..., None]), 0.0)
        lanes = torch.zeros((B, KV, G, 32), dtype=f32)
        for i in range(0, T, 32):
            lanes = lanes + p[..., i:i + 32]
        corr = torch.exp(m - m_new)
        l = l * corr + butterfly_sum(lanes)
        m = m_new
        vv = vc[:, s0:s0 + T].permute(0, 2, 1, 3) * vsc[:, s0:s0 + T].transpose(1, 2)[..., None]
        tacc = torch.zeros_like(acc)
        for i in range(0, T, R):
            tacc = tacc + p[..., i:i + R, None] * vv[:, :, None, i:i + R]
        acc = acc * corr[..., None, None] + tacc
    out = torch.zeros((B, KV, G, hd), dtype=f32)
    for r in range(R):
        out = out + acc[..., r, :]
    return out / torch.clamp(l, min=1e-30)[..., None]


@pytest.mark.parametrize("S,B,KV,G,hd,bits", [
    (48, 4, 16, 1, 64, 8),            # the fixed loop's qwen serve shape
    (48, 4, 32, 1, 128, 4),           # and codeqwen's
    (300, 3, 2, 3, 32, 8),            # an extent of 3 tiles
    (1000, 2, 132, 2, 16, 4),         # 8 tiles, but B * KV blocks fill the card
])
def test_walk_with_one_rank_is_the_one_block_walk_bit_for_bit(S, B, KV, G, hd, bits):
    assert KA.cluster_ranks(S, B, KV, G)[0] == 1
    lengths = tuple(int(x) for x in np.linspace(1, S, B))
    ops = _t(_cache_operands(S + hd, bits=bits, KV=KV, G=G, S=S, hd=hd, lengths=lengths))
    assert torch.equal(KA.kv_cache_attention_walk(*ops, bits=bits),
                       _one_block_walk(*ops, bits=bits))


def test_walk_rank_past_the_length_weighs_zero():
    """S 5000 over C = 14 ranks of 384 rows: lengths 4999 (a ragged last
    rank) and 700 (rank 1 cut, ranks 2-13 past it). A rank with no live row
    keeps m = -1e30, l = 0 and sums 0, and the merge weighs it by exactly
    0."""
    ops = _cache_operands(17, bits=8, KV=2, G=2, S=5000, lengths=(4999, 700))
    t = _t(ops)
    assert KA.cluster_ranks(5000, 2, 2, 2) == (14, 384)
    sums, m, l = KA.kv_cache_attention_walk(*t, bits=8, partials=True)
    assert (m[1, 2:] == -1e30).all() and (l[1, 2:] == 0).all() and (sums[1, 2:] == 0).all()
    assert (m[:, :2] > -1e30).all() and (m[0] > -1e30).all()
    assert (torch.exp(m[1, 2:] - m[1].amax(0)) == 0).all()
    out = KA.kv_cache_attention_walk(*t, bits=8)
    _close(out, jref.ref_kv_cache_attention(*ops, 8))


@pytest.mark.parametrize("extent,B,KV,G,unit,want", [
    (48, 4, 16, 1, 1, 1),             # kv_cache_attention, qwen serve (S 48)
    (48, 4, 32, 1, 1, 1),             # codeqwen serve
    (64, 4, 16, 1, 16, 1),            # paged_attention, qwen serve (4 x 16 rows)
    (64, 4, 32, 1, 16, 1),            # codeqwen serve
    (320, 2, 2, 8, 16, 1),            # the G = 8 edge rows
    (1000, 2, 4, 4, 1, 4),            # the GQA row, S 1000: ranks of 256 rows
    (8192, 2, 16, 1, 1, 11),          # long 8k, slot cache: ranks of 768 rows
    (32768, 2, 16, 1, 1, 12),         # long 32k, slot cache: 384 blocks
    (68 * 512, 2, 16, 1, 512, 12),    # long 32k, pool of 512-row blocks
    (20 * 512, 2, 16, 1, 512, 10),    # long 8k, pool: ranks of 2 whole blocks
    (5000, 2, 16, 1, 1, 10),          # the ragged slot-cache row
    (313 * 16, 2, 16, 1, 16, 10),     # the ragged pool row
    (32768, 4, 16, 1, 1, 6),          # 64 heads: 384 blocks
])
def test_cluster_ranks_at_the_smoke_shapes(extent, B, KV, G, unit, want):
    C, rows = KA.cluster_ranks(extent, B, KV, G, unit=unit)
    assert C == want
    step = max(KA.KERNEL_TILE, unit)
    assert rows % step == 0 and (C - 1) * rows < extent <= C * rows


def test_cluster_ranks_rule():
    """C depends on static shapes only: at most 16, 1 up to 3 tiles, and
    never more blocks than three an SM (two where G > 1), the most that
    stay resident at once."""
    for extent in (1, 127, 128, 1023, 1024, 4096, 5000, 8192, 100000):
        for B, KV in ((1, 1), (2, 16), (4, 16), (8, 32), (64, 64)):
            for G in (1, 4):
                C, rows = KA.cluster_ranks(extent, B, KV, G)
                assert 1 <= C <= 16 and (C - 1) * rows < extent <= C * rows
                tiles = -(-extent // KA.KERNEL_TILE)
                if tiles < 4:
                    assert C == 1
                if C > 1:
                    assert B * KV * C <= (3 if G == 1 else 2) * 132
                    assert rows >= 2 * KA.KERNEL_TILE


def test_registry_kv_cache_attention_on_cpu_and_wrapper_refuses_cpu():
    ops = _t(_cache_operands(2, bits=4, KV=2, G=2, S=30, lengths=(5, 30)))
    with obs_metrics.scoped(isolate=True) as reg:
        y = registry.dispatch("kv_cache_attention", *ops, bits=4)
    torch.testing.assert_close(y, KA.kv_cache_attention_plain(*ops, bits=4),
                               rtol=0, atol=0)
    assert reg.counter_total("kernel_dispatch_total", op="kv_cache_attention",
                             backend="ref", bits="4") == 1
    before = KA.kv_cache_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        KA.kv_cache_attention_cuda(*ops, bits=4)
    with pytest.raises(ValueError, match="CUDA"):
        registry.dispatch("kv_cache_attention", *ops, bits=4, backend="cuda")
    assert KA.kv_cache_attention_cuda.launches == before


def test_attn_backend_ref_gives_the_same_tokens_on_cpu():
    _, tc, _, tq, tokens, _ = _setup("qwen1.5-0.5b", "w2a2", "int4")
    a, la, _ = _run_port(tc, tq, tokens)
    b, lb, _ = _run_port(tc, tq, tokens, attn_backend="ref")
    assert (a == b).all()
    np.testing.assert_array_equal(la[1], lb[1])


def test_serve_cli_without_paged_on_cpu_prints_the_decode_line():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--plan", "w2a2"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stderr
    assert "decode: 60 tokens in" in out.stdout
    assert "sample generation (batch 0)" in out.stdout


def test_serve_fixed_runs_the_loop_and_counts_dispatches():
    args = serve.build_parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--plan", "w2a16",
         "--batch", "3", "--prompt-len", "7", "--gen", "4"])
    serve.validate_args(args)
    cfg, qparams = serve.prepare(args)
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    res = serve.serve_fixed(cfg, qparams, args)
    assert res["tokens"].shape == (3, 4)
    assert res["first_logits"].shape == (3, 1, cfg.vocab_size)
    assert res["decoded"] == 9
    assert res["dispatches"] == {"dequant_matmul:ref": 7 * cfg.n_layers * 4,
                                 "kv_cache_attention:ref": cfg.n_layers * 3}


@pytest.mark.parametrize("flags", [
    ["--prefix-cache"], ["--prefill-batch", "2"], ["--tp", "2"],
    ["--spec-draft-plan", "w2a2"], ["--kv-splits", "2"], ["--ring"],
    ["--trace-out", "t.json"], ["--metrics-out", "m.json"]])
def test_serve_requires_paged_for_engine_flags(flags):
    args = serve.build_parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", *flags])
    with pytest.raises(ValueError, match=f"{flags[0]} requires --paged"):
        serve.validate_args(args)


def test_serve_fixed_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(reduce_for_smoke(get_config("qwen1.5-0.5b")), 1, 4)
