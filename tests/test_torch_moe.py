"""The port's MoE path against the JAX reference on the reduced
moonshot-v1-16b-a3b (4 experts, top-2, d_ff_expert 64, dispatch groups of
16; two layers), on the same numpy inputs and weights:

  * plain ``expert_dequant_matmul`` / ``expert_lut_gemm`` against the
    reference's ``ref_expert_*`` oracles and its Pallas kernels run in
    interpret mode;
  * ``quantize_expert_weight``, ``quantize_tree`` and the bridge, bit for
    bit; the layer-by-layer init-and-pack against init + quantize_tree;
  * ``moe_apply`` with forced capacity drops (capacity_factor 0.25: C = 4
    of 16 tokens per group), the routing indices first;
  * whole-forward logits, the paged engine's greedy tokens against the
    reference engine's (int8 pool, pad rows, a step with an empty slot,
    capacity drops in the prefill chunks), and the serve CLI.

Tolerances: expert_lut_gemm per channel is bit-identical (exact integer
sums in f32); grouped 1e-5 relative (another summation order). The dequant
matmul sums f32 products in another order than XLA's dot: 1e-5 relative.
Packed leaves are bit-identical. float32 layers and logits 1e-4 relative
and absolute, as for the dense model: the LUT core is exact, and the rest
differs in f32 summation order (the combine sums each token's experts in
slot order, XLA's einsum in expert order) and transcendental ulps. The
reference runs its plans on the 'ref' backend, whose w{b}a{b} expert route
is a dequant einsum; the port runs the LUT op, whose plain version sums the
same exact integer products per channel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduce_for_smoke as jreduce
from repro.core import qlinear as jqlinear, qplan as jqplan
from repro.core.lut import ProductLUT as JProductLUT
from repro.kernels import ref as jref
from repro.kernels.expert_dequant_matmul import (expert_dequant_matmul_pallas,
                                                 expert_lut_gemm_pallas)
from repro.models import layers as jL, lm as jlm
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import packing, qlinear, qplan, quant
from repro_torch.core.lut import product_lut
from repro_torch.core.qlinear import QuantizedWeight
from repro_torch.kernels import registry
from repro_torch.kernels.ref import ref_expert_dequant_matmul
from repro_torch.kernels.expert_gemm import (expert_dequant_matmul_cuda,
                                             expert_dequant_matmul_plain,
                                             expert_lut_gemm_cuda,
                                             expert_lut_gemm_plain)
from repro_torch.launch import serve
from repro_torch.models import layers as L, lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving import Engine, Request

KEY = jax.random.PRNGKey(0)
ARCH = "moonshot-v1-16b-a3b"
RTOL = 1e-5
F32_TOL = 1e-4
DROP_CF = 0.25          # capacity factor that forces drops at smoke width
PLANS = ("w2a2", "w2a2g64", "w2a16", "w2a16g64", "w2a8_bs")


def _cfgs(plan: str, *, n_layers: int = 2, cf: float = DROP_CF, kv: str = "int8"):
    def cut(cfg, plans):
        return dataclasses.replace(
            cfg, n_layers=n_layers, dtype="float32", kv_cache_dtype=kv,
            moe=dataclasses.replace(cfg.moe, capacity_factor=cf),
            quant=dataclasses.replace(plans[plan], backend="ref"))
    return (cut(jreduce(jget_config(ARCH)), jqplan.PLANS),
            cut(reduce_for_smoke(get_config(ARCH)), qplan.PLANS))


_SETUP = {}


def _setup(plan: str, **kw):
    """Reference config, port config, the reference's plain and packed
    trees (numpy leaves) and the port's packed tree via the bridge."""
    key = (plan, tuple(sorted(kw.items())))
    if key not in _SETUP:
        jc, tc = _cfgs(plan, **kw)
        params = jlm.init_params(KEY, jc)
        qp = jlm.quantize_tree(params, jc)
        tq = bridge.qparams_from_jax(jax.tree.map(np.asarray, qp), tc, device="cpu")
        _SETUP[key] = (jc, tc, params, qp, tq)
    return _SETUP[key]


def _eq(t: torch.Tensor, a) -> None:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    else:
        np.testing.assert_array_equal(t.numpy(), a)


def _leaf_eq(mine: QuantizedWeight, ref: QuantizedWeight) -> None:
    for f in ("packed", "codebook", "scales", "a_levels", "plut"):
        x, y = getattr(mine, f), getattr(ref, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    for f in ("bits", "in_features", "out_features", "group_size", "a_bits",
              "scheme", "kernel"):
        assert getattr(mine, f) == getattr(ref, f), f


# --------------------------------------------------------------------------- #
# the two kernels' plain versions
# --------------------------------------------------------------------------- #

_KERNEL_CASES = [(E, M, K, N, b, g) for (E, M, K, N) in ((3, 5, 128, 32), (1, 16, 256, 96))
                 for (b, g) in ((2, None), (2, 64), (4, None), (4, 32))]


@pytest.mark.parametrize("E,M,K,N,bits,group", _KERNEL_CASES)
def test_plain_expert_dequant_matmul_matches_oracle_and_pallas(E, M, K, N, bits,
                                                               group):
    rng = np.random.default_rng(E * M + K + bits)
    x = rng.normal(size=(E, M, K)).astype(np.float32)
    idx = rng.integers(0, 2 ** bits, size=(E, N, K)).astype(np.uint8)
    wp = packing.pack(torch.from_numpy(idx), bits)
    cb = rng.normal(size=(2 ** bits,)).astype(np.float32)     # non-uniform too
    sc = rng.uniform(0.01, 0.1, size=(E, N) if group is None else (E, N, K // group))
    sc = sc.astype(np.float32)
    got = expert_dequant_matmul_plain(torch.from_numpy(x), wp, torch.from_numpy(cb),
                                      torch.from_numpy(sc), bits=bits,
                                      group_size=group)
    assert got.shape == (E, M, N) and got.is_contiguous()
    want = np.asarray(jref.ref_expert_dequant_matmul(
        jnp.asarray(x), jnp.asarray(wp.numpy()), jnp.asarray(cb), jnp.asarray(sc),
        bits, group_size=group))
    want_pl = np.asarray(expert_dequant_matmul_pallas(
        jnp.asarray(x), jnp.asarray(wp.numpy()), jnp.asarray(cb), jnp.asarray(sc),
        bits=bits, group_size=group, interpret=True))
    oracle = ref_expert_dequant_matmul(torch.from_numpy(x), wp, torch.from_numpy(cb),
                                       torch.from_numpy(sc), bits, group_size=group)
    scale = np.abs(want).max()
    for g, w in ((got, want), (got, want_pl), (oracle, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("E,M,K,N,bits,group", _KERNEL_CASES)
def test_plain_expert_lut_gemm_matches_oracle_and_pallas(E, M, K, N, bits, group):
    rng = np.random.default_rng(E * M + K + bits + 1)
    a_idx = rng.integers(0, 2 ** bits, size=(E, M, K)).astype(np.uint8)
    w_idx = rng.integers(0, 2 ** bits, size=(E, N, K)).astype(np.uint8)
    ap = packing.pack(torch.from_numpy(a_idx), bits)
    wp = packing.pack(torch.from_numpy(w_idx), bits)
    lut = product_lut(quant.uniform_codebook(bits), quant.uniform_codebook(bits)).table
    sc = None if group is None else rng.uniform(
        0.01, 0.1, size=(E, N, K // group)).astype(np.float32)
    got = expert_lut_gemm_plain(ap, wp, lut, None if sc is None else torch.from_numpy(sc),
                                w_bits=bits, a_bits=bits, group_size=group)
    assert got.shape == (E, M, N) and got.is_contiguous()
    jsc = None if sc is None else jnp.asarray(sc)
    want = np.asarray(jref.ref_expert_lut_gemm(
        jnp.asarray(ap.numpy()), jnp.asarray(wp.numpy()),
        JProductLUT(jnp.asarray(lut.numpy()), bits, bits), w_scales=jsc,
        group_size=group))
    want_pl = np.asarray(expert_lut_gemm_pallas(
        jnp.asarray(ap.numpy()), jnp.asarray(wp.numpy()), jnp.asarray(lut.numpy()),
        jsc, bits=bits, scheme="d", group_size=group, interpret=True))
    for w in (want, want_pl):
        if group is None:
            np.testing.assert_array_equal(got.numpy(), w)
        else:
            np.testing.assert_allclose(got.numpy(), w, rtol=RTOL,
                                       atol=RTOL * np.abs(w).max())


def test_expert_ops_registered_counted_and_kernels_refuse_cpu_tensors():
    rng = np.random.default_rng(0)
    ap = packing.pack(torch.from_numpy(rng.integers(0, 4, (3, 4, 64)).astype(np.uint8)), 2)
    wp = packing.pack(torch.from_numpy(rng.integers(0, 4, (3, 8, 64)).astype(np.uint8)), 2)
    lut = product_lut(quant.uniform_codebook(2), quant.uniform_codebook(2)).table
    x = torch.from_numpy(rng.normal(size=(3, 4, 64)).astype(np.float32))
    cb, sc = quant.uniform_codebook(2).levels, torch.ones((3, 8))
    with obs_metrics.scoped(isolate=True) as reg:
        y = registry.dispatch("expert_lut_gemm", ap, wp, lut, None, w_bits=2,
                              a_bits=2, scheme="d", group_size=None)
        z = registry.dispatch("expert_dequant_matmul", x, wp, cb, sc, bits=2,
                              group_size=None)
    np.testing.assert_array_equal(
        y.numpy(), expert_lut_gemm_plain(ap, wp, lut, w_bits=2, a_bits=2).numpy())
    np.testing.assert_array_equal(
        z.numpy(), expert_dequant_matmul_plain(x, wp, cb, sc, bits=2).numpy())
    for op in ("expert_lut_gemm", "expert_dequant_matmul"):   # m_bucket: E
        assert reg.counter_total("kernel_dispatch_total", op=op, backend="ref",
                                 m_bucket="3", bits="2") == 1
    with pytest.raises(ValueError, match="CUDA"):
        expert_lut_gemm_cuda(ap, wp, lut, w_bits=2, a_bits=2)
    with pytest.raises(ValueError, match="CUDA"):
        expert_dequant_matmul_cuda(x, wp, cb, sc, bits=2)
    with pytest.raises(ValueError, match="CUDA"):
        registry.dispatch("expert_dequant_matmul", x, wp, cb, sc, bits=2,
                          backend="cuda")


# --------------------------------------------------------------------------- #
# packing, the bridge, init
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("plan", ["w2a2", "w2a2g64", "w2a16", "w2a16g64",
                                  "w4a16", "w2a8_bs", "mixed_attn4_mlp2"])
def test_quantize_expert_weight_bit_identical(plan):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 96, 40)).astype(np.float32)       # K 96, N 40
    pol = qplan.PLANS[plan].policy_for("layers.0.moe.experts.we_up")
    jpol = jqplan.PLANS[plan].policy_for("blocks.l0.moe.experts.we_up")
    mine = qlinear.quantize_expert_weight(torch.from_numpy(w), pol)
    jqw = jax.tree.map(np.asarray, jqlinear.quantize_expert_weight(jnp.asarray(w), jpol))
    _leaf_eq(mine, bridge._qw_from(jqw, None, "cpu"))
    assert mine.packed.shape[:2] == (3, 40) and mine.k_padded >= 96
    # dequant_weight takes the expert axis: (E, in, out)
    np.testing.assert_array_equal(
        qlinear.dequant_weight(mine).numpy(),
        np.asarray(jqlinear.dequant_weight(jqlinear.quantize_expert_weight(
            jnp.asarray(w), jpol))))


@pytest.mark.parametrize("plan", ["w2a2", "w2a16g64", "w2a8_bs"])
def test_quantize_tree_and_bridge_bit_identical_on_moe_tree(plan):
    """The port's quantize_tree on the reference's plain weights (bridged)
    packs exactly the leaves the reference's quantize_tree packed (bridged):
    expert stacks per layer, the shared expert, attention; the router stays
    a raw f32 array, bit for bit."""
    jc, tc, params, qp, tq = _setup(plan)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    mine = lm.quantize_tree(tp, tc)
    n = 0
    for i, (lm_, lr) in enumerate(zip(mine["layers"], tq["layers"])):
        jm = jax.tree.map(lambda a: np.asarray(a)[i], params["blocks"]["l0"]["moe"])
        _eq(tp["layers"][i]["moe"]["we_down"], jm["we_down"])      # plain, unstacked
        assert lm_["moe"]["w_router"].dtype == torch.float32
        _eq(lm_["moe"]["w_router"], jm["w_router"])
        _eq(lr["moe"]["w_router"], jm["w_router"])
        for name in ("we_gate", "we_up", "we_down"):
            _leaf_eq(lm_["moe"][name], lr["moe"][name])
            n += 1
        for blk, sub in (("attn", lm_["attn"]), ("shared", lm_["moe"]["shared"])):
            ref_sub = lr["attn"] if blk == "attn" else lr["moe"]["shared"]
            for name, leaf in sub.items():
                _leaf_eq(leaf["qw"], ref_sub[name]["qw"])
                n += 1
    assert n == tc.n_layers * (3 + 4 + 3)
    jqw = qp["blocks"]["l0"]["moe"]["we_up"]
    np.testing.assert_array_equal(tq["layers"][1]["moe"]["we_up"].packed.numpy(),
                                  np.asarray(jqw.packed)[1])


@pytest.mark.parametrize("arch,plan", [(ARCH, "w2a2"), (ARCH, "w2a16"),
                                       (ARCH, "w2a8_bs"), ("qwen1.5-0.5b", "w2a2")])
def test_layer_by_layer_init_and_pack_equals_init_then_quantize_tree(arch, plan):
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), n_layers=2,
                              quant=qplan.PLANS[plan])
    whole = lm.quantize_tree(lm.init_params(cfg, torch.Generator().manual_seed(5),
                                            "cpu"), cfg)
    packed = lm.init_params(cfg, torch.Generator().manual_seed(5), "cpu", pack=True)

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, QuantizedWeight):
            _leaf_eq(a, b)
        else:
            assert a.dtype == b.dtype
            assert torch.equal(a, b)

    same(whole, packed)
    assert isinstance(packed["layers"][0]["attn"]["wq"]["qw"], QuantizedWeight)


def test_init_params_matches_reference_structure():
    jc, tc, params, _, _ = _setup("w2a2")
    ref = bridge.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    mine = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert shapes(mine) == shapes(ref)
    assert tc.moe_flags() == jc.moe_flags() == (True, True)


# --------------------------------------------------------------------------- #
# moe_apply, forward, engine, CLI
# --------------------------------------------------------------------------- #

def _jax_route(jp, x, jc):
    """The reference's routing (layers.py:803-808) on (G, gs, D) tokens."""
    logits = x.astype(jnp.float32) @ jp["w_router"]
    return jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jc.moe.top_k)


def _drops(idx_k: torch.Tensor, C: int, E: int) -> int:
    counts = torch.stack([torch.bincount(g.reshape(-1), minlength=E) for g in idx_k])
    return int((counts - C).clamp(min=0).sum())


@pytest.mark.parametrize("plan", PLANS)
def test_moe_apply_matches_reference_with_capacity_drops(plan):
    jc, tc, _, qp, tq = _setup(plan)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, tc.d_model)).astype(np.float32)   # T 32: 2 groups
    for i in range(tc.n_layers):
        jp = jax.tree.map(lambda a: a[i], qp["blocks"])["l0"]["moe"]
        tp = tq["layers"][i]["moe"]
        gs, C = L.moe_capacity(tc.moe, 32)
        assert (gs, C) == (16, 4)
        _, jidx = _jax_route(jp, jnp.asarray(x).reshape(2, gs, -1), jc)
        _, idx = L.moe_route(tp, torch.from_numpy(x).reshape(2, gs, -1), tc.moe.top_k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert _drops(idx, C, tc.moe.n_experts) > 0
        want = np.asarray(jL.moe_apply(jp, jnp.asarray(x), cfg=jc))
        got = L.moe_apply(tp, torch.from_numpy(x), cfg=tc)
        assert got.dtype == torch.float32 and got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("plan", ["w2a2", "w2a16", "w2a2g64"])
def test_moe_apply_gives_the_same_bits_with_and_without_the_active_flag(plan,
                                                                       monkeypatch):
    """moe_apply flags the experts that hold a token and the expert ops zero
    the others instead of computing them: the layer's output is the
    unflagged run's bit for bit, with every expert filled (a 32-token
    prefill) and at decode, where some experts hold no token."""
    _, tc, _, _, tq = _setup(plan)
    orig = L._expert_matmul
    flags = []

    def flagged(qw, x, backend, active=None):
        flags.append(active)
        return orig(qw, x, backend, active)

    def unflagged(qw, x, backend, active=None):
        return orig(qw, x, backend)

    rng = np.random.default_rng(5)
    for B, S in ((2, 16), (1, 1), (2, 1)):
        x = torch.from_numpy(rng.normal(size=(B, S, tc.d_model)).astype(np.float32))
        for i in range(tc.n_layers):
            tp = tq["layers"][i]["moe"]
            monkeypatch.setattr(L, "_expert_matmul", flagged)
            got = L.moe_apply(tp, x, cfg=tc)
            monkeypatch.setattr(L, "_expert_matmul", unflagged)
            want = L.moe_apply(tp, x, cfg=tc)
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert len(flags) == 3 * 3 * tc.n_layers
    assert all(a.shape == (tc.moe.n_experts,) and a.dtype == torch.bool for a in flags)
    assert any(not bool(a.all()) for a in flags)        # some experts were skipped
    assert all(bool(a.any()) for a in flags)


@pytest.mark.parametrize("plan", ["w2a2", "w2a16", "w2a8_bs"])
def test_forward_logits_match_reference(plan):
    jc, tc, _, qp, tq = _setup(plan)
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size, size=(2, 16))
    jh, _ = jlm.forward(qp, jc, jnp.asarray(tokens, jnp.int32))
    th, _ = lm.forward(tq, tc, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lm.logits_fn(tq, tc, th).numpy(),
                               np.asarray(jlm.logits_fn(qp, jc, jh)),
                               rtol=F32_TOL, atol=F32_TOL)


PROMPT_LENS = (5, 21, 9)        # pad rows in every chunk; the third runs alone
MAX_NEW = 5
ENGINE_KW = dict(n_slots=2, max_len=48, block_size=8, chunk_size=16)


@pytest.mark.parametrize("plan", ["w2a2", "w2a16"])
def test_greedy_tokens_match_reference_engine(plan, monkeypatch):
    """Greedy tokens of the port's engine equal the reference engine's on
    the int8 pool. Prefill chunks of 16 rows (pad token 0 past the prompt)
    drop assignments at C = 4; decode steps run with an empty slot once
    the first two requests finish."""
    jc, tc, _, qp, tq = _setup(plan)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]

    jeng = JEngine(jc, qp, **ENGINE_KW)
    jreqs = [JRequest(uid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    for r in jreqs:
        assert jeng.submit(r)
    jeng.run()

    seen = {"drops": 0, "empty_slot_steps": 0}
    route = L.moe_route

    def counting(p, xg, top_k):
        gate, idx = route(p, xg, top_k)
        _, C = L.moe_capacity(tc.moe, xg.shape[0] * xg.shape[1])
        seen["drops"] += _drops(idx, C, tc.moe.n_experts)
        return gate, idx

    monkeypatch.setattr(L, "moe_route", counting)
    eng = Engine(tc, tq, **ENGINE_KW)
    decode = eng._do_decode

    def note_empty_slot():
        if any(s.req is None for s in eng.slots) and any(s.req is not None
                                                         for s in eng.slots):
            seen["empty_slot_steps"] += 1
        decode()

    eng._do_decode = note_empty_slot
    reqs = [Request(uid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    m = eng.run()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert seen["drops"] > 0 and seen["empty_slot_steps"] > 0
    assert (m["decode_steps"], m["prefill_chunks"]) == (jeng.decode_steps,
                                                        jeng.prefill_chunks)
    op = "expert_lut_gemm" if plan == "w2a2" else "expert_dequant_matmul"
    counts = m["metrics"]["counters"]
    n = sum(v for k, v in counts.items()
            if k.startswith("kernel_dispatch_total{") and k.endswith(f"op={op}}}"))
    assert n == 3 * tc.n_layers * (m["decode_steps"] + m["prefill_chunks"])


@pytest.mark.parametrize("plan,ops", [
    ("w2a2", ("expert_lut_gemm", "lut_gemm")),
    ("w2a16", ("expert_dequant_matmul", "dequant_matmul")),
    ("w2a8_bs", ("expert_dequant_matmul", "lut_gemm_bs_fused"))])
def test_serve_cli_serves_moe_on_cpu(plan, ops, capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--paged", "--device", "cpu",
                       "--plan", plan, "--requests", "3", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "3/3 requests" in out
    expert, dense = ops
    assert f"'{expert}:ref': " in out and f"'{dense}:ref': " in out
