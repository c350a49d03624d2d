"""The port's tensor-parallel slice against the JAX reference and against
its own single-rank runs: the plain version of the two-step bit-sliced
GEMM (``lut_gemm_bitsliced_plain``) against the reference's oracle and its
Pallas kernel in interpret mode; the two-step route against the fused
route; the four TP rules of the dense GEMM ops at op level on 2 ranks; the
bridge's rank slices of a ``quantize_tree(tp=2)`` tree and the port's own
``tp=2`` packing; and the paged engine at ``--tp 2`` against the port's
single-rank engine and the reference's unsharded engine on the same tree.

Ranks are spawned through the port's own launcher (``launch/mesh.py``)
as 2 gloo processes on the CPU; the JAX side runs in this process. The
reference's own sharded tests cannot serve as oracles here (jax 0.9.0
refuses their ``shard_map(check_rep=...)``), so TP is held against the
unsharded reference and the port's tp=1 run.

Tolerances: per channel every GEMM here sums exact integers, so a column
slice, a K slice summed over the ranks and the two-step route are
bit-identical to the unsharded op (and the engine's tokens and logits to
its tp=1 run). Group-scaled sums and the f32 dequant matmul summed over
two K halves round in another order: 1e-5 of the largest output per op,
and TOL_LOGITS of the largest logit for the engine. Against the reference
engine the tokens must match up to a near tie (the margin rule of
test_torch_engine.py, as test_torch_bitsliced.py uses it).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduce_for_smoke as jreduce
from repro.core import qplan as jqplan
from repro.kernels import ref as jref
from repro.kernels.lut_gemm_bitsliced import lut_gemm_bitsliced_pallas
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import packing, qlinear, qplan, quant
from repro_torch.kernels import registry
from repro_torch.kernels.lut_gemm_bitsliced import (lut_gemm_bitsliced_cuda,
                                                    lut_gemm_bitsliced_plain)
from repro_torch.launch import mesh, serve
from repro_torch.models import lm

import test_torch_engine as te

KEY = jax.random.PRNGKey(0)
RTOL = 1e-5                 # group-scaled / dequant sums over K halves
TOL_LOGITS = 1e-4           # engine logits, relative to max|logit|
ENGINE_PLANS = {"w2a8_bs": dict(w_bits=2, a_bits=8, kernel="lut_gemm_bitsliced"),
                "w2a8_bs_g64": dict(w_bits=2, a_bits=8, group_size=64,
                                    kernel="lut_gemm_bitsliced"),
                "w2a2": dict(w_bits=2, a_bits=2),
                "w2a16": dict(w_bits=2)}
EXACT_PLANS = ("w2a8_bs", "w2a2")      # integer sums per channel


def _close(want, got, exact):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


# --------------------------------------------------------------------------- #
# The two-step op's plain version
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("group", [None, 64])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("M", [1, 4, 32])
def test_plain_two_step_matches_oracle_and_pallas_interpret(M, bits, group):
    rng = np.random.default_rng(M * 10 + bits)
    K, N = 256, 24
    codes = rng.integers(-128, 128, (M, K)).astype(np.int8)
    idx = rng.integers(0, 2 ** bits, (N, K)).astype(np.uint8)
    sc = None if group is None else \
        (rng.random((N, K // group)) * 0.02 + 0.01).astype(np.float32)
    planes = packing.pack_bitplanes_signed(torch.from_numpy(idx), bits)
    got = lut_gemm_bitsliced_plain(
        torch.from_numpy(codes), planes, None if sc is None else torch.from_numpy(sc),
        w_bits=bits, group_size=group).numpy()
    jargs = (jnp.asarray(codes), jnp.asarray(planes.numpy()),
             None if sc is None else jnp.asarray(sc))
    want_ref = np.asarray(jref.ref_lut_gemm_bitsliced(*jargs, bits=bits,
                                                      group_size=group))
    want_pl = np.asarray(lut_gemm_bitsliced_pallas(*jargs, bits=bits, group_size=group,
                                                   interpret=True))
    _close(want_ref, got, group is None)
    _close(want_pl, got, group is None)
    if group is None:
        exact = codes.astype(np.int64) @ (idx.astype(np.int64) - 2 ** (bits - 1)).T
        np.testing.assert_array_equal(got, exact.astype(np.float32))
    else:            # groups summed in ascending order, one rounding each
        part = (codes.astype(np.int64).reshape(M, 1, K // group, group)
                * (idx.astype(np.int64) - 2 ** (bits - 1)).reshape(1, N, K // group, group)
                ).sum(-1).astype(np.float32) * sc[None]
        seq = part[..., 0]
        for g in range(1, K // group):
            seq = seq + part[..., g]
        np.testing.assert_array_equal(got, seq)


def test_two_step_op_registered_and_kernel_refuses_cpu_tensors():
    codes = torch.zeros((4, 64), dtype=torch.int8)
    planes = packing.pack_bitplanes_signed(torch.zeros((16, 64), dtype=torch.uint8), 2)
    before = lut_gemm_bitsliced_cuda.launches
    np.testing.assert_array_equal(
        registry.dispatch("lut_gemm_bitsliced", codes, planes, None, w_bits=2).numpy(),
        lut_gemm_bitsliced_plain(codes, planes, w_bits=2).numpy())
    assert lut_gemm_bitsliced_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        lut_gemm_bitsliced_cuda(codes, planes, w_bits=2)
    with pytest.raises(ValueError, match="group_size"):
        lut_gemm_bitsliced_cuda(codes, planes, torch.ones((16, 1)), w_bits=2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_two_step_route_bit_identical_to_fused_route_per_channel(M, bits, dtype):
    """The rows quantized once outside the op (dense_serve's two-step route)
    give the fused op's codes, and the epilogue is its epilogue: per channel
    the two routes are bit-identical (the reference's
    test_fused_bit_identical_to_two_step_per_channel)."""
    rng = np.random.default_rng(3 * bits + M)
    K, N = 128, 16
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dtype)
    idx = rng.integers(0, 2 ** bits, (N, K)).astype(np.uint8)
    planes = packing.pack_bitplanes_signed(torch.from_numpy(idx), bits)
    sc = torch.from_numpy((rng.random(N) * 0.02 + 0.01).astype(np.float32))
    a_scale, _ = quant.compute_scale_zero_point(x, 8, signed=True, axis=0)
    aq = quant.quantize(x, a_scale, bits=8, signed=True)
    two = registry.dispatch("lut_gemm_bitsliced", aq, planes, None, w_bits=bits)
    two = two * sc[None, :] * a_scale
    fused = registry.dispatch("lut_gemm_bs_fused", x, planes, sc, None, w_bits=bits)
    np.testing.assert_array_equal(two.numpy(), fused.numpy())


# --------------------------------------------------------------------------- #
# The TP rules at op level, 2 ranks
# --------------------------------------------------------------------------- #

def _pol(plan):
    return qplan.get_plan(plan).rules[-1][1]


# (case, plan, role, K, N): one projection per case; N 27 does not divide
# over 2 ranks, so the col leaf stays whole; K 192 under g64 pads to 256
_OP_CASES = [
    ("lut_gemm col", "w2a2", "col", 128, 48),
    ("lut_gemm row", "w2a2", "row", 128, 48),
    ("lut_gemm g64 col", "w2a2g64", "col", 128, 48),
    ("lut_gemm g64 row", "w2a2g64", "row", 192, 48),
    ("dequant_matmul col", "w2a16", "col", 128, 48),
    ("dequant_matmul row", "w2a16", "row", 128, 48),
    ("dequant_matmul g64 row", "w2a16g64", "row", 128, 48),
    ("lut_gemm_bs_fused col", "w2a8_bs", "col", 128, 48),
    ("lut_gemm_bs_fused g64 col", "w2a8_bs_g64", "col", 128, 48),
    ("lut_gemm_bitsliced row", "w2a8_bs", "row", 128, 48),
    ("lut_gemm_bitsliced w4 row", "w4a8_bs", "row", 128, 48),
    ("lut_gemm_bitsliced g64 row", "w2a8_bs_g64", "row", 192, 48),
    ("col, N does not divide", "w2a8_bs", "col", 128, 27),
]
_OP_RUN = {}


def _op_inputs(i, plan, role, K, N):
    rng = np.random.default_rng(100 + i)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    x = rng.standard_normal((5, K)).astype(np.float32)
    return w, _pol(plan), role, x, "auto"


def _op_results():
    if not _OP_RUN:
        cases = [_op_inputs(i, *c[1:]) for i, c in enumerate(_OP_CASES)]
        out = mesh.run_ranks(mesh.dense_rank, 2, cases, device="cpu")
        _OP_RUN.update(zip((c[0] for c in _OP_CASES), zip(cases, out)))
    return _OP_RUN


@pytest.mark.parametrize("case", [c[0] for c in _OP_CASES])
def test_tp_rule_on_two_ranks_equals_unsharded_op(case):
    (w, pol, role, x, backend), (got, was_cut) = _op_results()[case]
    qw = qlinear.quantize_weight(torch.from_numpy(w), pol, tp_role=role, tp_shards=2)
    want = qlinear.dense_serve(qw, torch.from_numpy(x), backend=backend).numpy()
    assert was_cut == (w.shape[1] % 2 == 0 or role == "row")
    integer = pol.group_size is None and pol.a_bits is not None
    _close(want, got, exact=role == "col" or not was_cut or integer)
    row_op = {"lut_gemm_bitsliced": "lut_gemm_bitsliced"}.get(case.split()[0])
    if row_op:          # the row leaf really took the two-step route
        assert qw.tp == "row" and qw.kernel == "lut_gemm_bitsliced"


def test_row_leaf_pads_k_for_the_shards_like_the_reference():
    """A row leaf's K is padded to the scale group times the shard count
    (192 -> 256 at g64 x 2), as ``_k_multiple(policy, tp)`` does there;
    a column leaf keeps its own padding."""
    from repro.core import qlinear as jqlinear
    w = np.random.default_rng(0).standard_normal((192, 16)).astype(np.float32)
    for plan in ("w2a8_bs_g64", "w2a2g64", "w2a16", "w2a2"):
        for role in ("row", "col"):
            mine = qlinear.quantize_weight(torch.from_numpy(w), _pol(plan),
                                           tp_role=role, tp_shards=2)
            ref = jqlinear.quantize_weight(jnp.asarray(w),
                                           jqplan.get_plan(plan).rules[-1][1],
                                           tp_role=role, tp_shards=2)
            assert mine.k_padded == ref.k_padded and mine.tp == ref.tp == role
            np.testing.assert_array_equal(mine.packed.numpy(), np.asarray(ref.packed))


# --------------------------------------------------------------------------- #
# Trees: the bridge's rank slices and the port's own tp=2 packing
# --------------------------------------------------------------------------- #

_TREES = {}


def _cfgs(plan, arch="qwen1.5-0.5b"):
    kw = ENGINE_PLANS[plan] if plan in ENGINE_PLANS else {}
    jq = jqplan.make_plan(**kw, backend="ref") if kw else jqplan.PLANS[plan]
    tq = qplan.make_plan(**kw) if kw else qplan.PLANS[plan]
    jc = dataclasses.replace(jreduce(jget_config(arch)), n_layers=2, dtype="float32",
                             kv_cache_dtype="int8", quant=jq)
    tc = dataclasses.replace(reduce_for_smoke(get_config(arch)), n_layers=2,
                             dtype="float32", kv_cache_dtype="int8", quant=tq)
    return jc, tc


def _tree(plan):
    """(reference config, port config, plain params, the tp=2-packed tree
    with numpy leaves, the same tree as the reference holds it)."""
    if plan not in _TREES:
        jc, tc = _cfgs(plan)
        params = jlm.init_params(KEY, jc)
        jq = jlm.quantize_tree(params, jc, tp=2)
        _TREES[plan] = (jc, tc, params, jax.tree.map(np.asarray, jq), jq)
    return _TREES[plan]


def _jax_free(tree):
    """The numpy tree with each reference ``QuantizedWeight`` turned into a
    plain namespace of the fields the bridge reads, so that a spawned rank
    unpickles it without importing jax."""
    if hasattr(tree, "packed") and hasattr(tree, "codebook"):
        return types.SimpleNamespace(**{f: getattr(tree, f) for f in (
            "packed", "codebook", "scales", "a_levels", "plut", "a_sc", "bits",
            "in_features", "out_features", "group_size", "a_bits", "scheme",
            "kernel", "tp")})
    if isinstance(tree, dict):
        return {k: _jax_free(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("plan", ["w2a8_bs_g64", "w2a2", "w2a16"])
def test_bridge_rank_slices_concatenate_to_the_tree_and_match_own_packing(plan):
    jc, tc, params, qp, _ = _tree(plan)
    whole = lm.qweights(bridge.qparams_from_jax(qp, tc, device="cpu"))
    ranks = [lm.qweights(bridge.qparams_from_jax(qp, tc, device="cpu", tp_rank=r,
                                                 tp_size=2)) for r in range(2)]
    own = lm.qweights(lm.quantize_tree(
        bridge.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu"),
        tc, tp=2))
    roles = set()
    for path, w in whole.items():
        parts = [r[path] for r in ranks]
        assert all(p.tp == w.tp for p in parts), path
        roles.add(w.tp)
        np.testing.assert_array_equal(own[path].packed.numpy(), w.packed.numpy())
        assert own[path].tp == w.tp and own[path].k_padded == w.k_padded
        for r in range(2):
            mine = lm.shard_tree(own[path], r, 2)
            for f in ("packed", "scales", "codebook"):
                np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                              getattr(parts[r], f).numpy())
        axis = {"col": -2 if w.scheme == "bs" else 0, "row": -1}[w.tp]
        np.testing.assert_array_equal(
            torch.cat([p.packed for p in parts], axis).numpy(), w.packed.numpy())
        assert all(p.k_padded == w.k_padded for p in parts)
        if w.group_size is not None or w.tp == "col" and w.kernel != "lut_gemm":
            sc_axis = 0 if w.tp == "col" else -1
            np.testing.assert_array_equal(
                torch.cat([p.scales for p in parts], sc_axis).numpy(), w.scales.numpy())
        else:
            assert all(torch.equal(p.scales, w.scales) for p in parts)
    assert roles == {"col", "row"}


def test_moe_tree_under_tp_raises_and_cli_checks_tp_flags():
    jc, tc = _cfgs("w2a2", arch="moonshot-v1-16b-a3b")
    params = jlm.init_params(KEY, jc)
    qp = jax.tree.map(np.asarray, jlm.quantize_tree(params, jc, tp=2))
    with pytest.raises(NotImplementedError, match="expert.*queue 1, item 11"):
        bridge.qparams_from_jax(qp, tc, device="cpu", tp_rank=0, tp_size=2)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    with pytest.raises(NotImplementedError, match="expert.*queue 1, item 11"):
        lm.quantize_tree(tparams, tc, tp=2)
    with pytest.raises(ValueError, match="pack=True"):
        lm.init_params(tc, torch.Generator().manual_seed(0), "cpu", tp=2)
    ap = serve.build_parser()
    for flags, msg in ((["--tp", "2"], "--tp requires --paged"),
                       (["--tp", "0", "--paged"], "--tp must be >= 1"),
                       (["--tp", "2", "--paged", "--arch", "moonshot-v1-16b-a3b"],
                        "MoE.*queue 1, item 11")):
        args = ap.parse_args(["--arch", "qwen1.5-0.5b", "--smoke", "--device",
                              "cpu", *flags])
        with pytest.raises(ValueError, match=msg):
            serve.validate_args(args)


# --------------------------------------------------------------------------- #
# The engine at tp=2
# --------------------------------------------------------------------------- #

_ENGINES = {}


def _engines():
    """Every plan's tp=2 engine run (one spawn of 2 ranks for all)."""
    if not _ENGINES:
        rng = np.random.default_rng(1)
        jobs = []
        for plan in ENGINE_PLANS:
            jc, tc, _, qp, _ = _tree(plan)
            prompts = [rng.integers(0, jc.vocab_size, size=n).astype(np.int32)
                       for n in te.PROMPT_LENS]
            jobs.append((plan, tc, qp, prompts))
        out = mesh.run_ranks(mesh.engine_rank, 2,
                             [(_jax_free(qp), tc, p, te.MAX_NEW, te.ENGINE_KW)
                              for _, tc, qp, p in jobs], device="cpu")
        for (plan, tc, qp, prompts), res in zip(jobs, out):
            _ENGINES[plan] = (prompts, res)
    return _ENGINES


def _run_tp1(tc, qp, prompts):
    from repro_torch.serving import Engine, Request
    eng = Engine(tc, bridge.qparams_from_jax(qp, tc, device="cpu"), **te.ENGINE_KW)
    logits = []
    inner = eng._decode_fn

    def keep(*a):
        out = inner(*a)
        logits.append(out.clone())
        return out

    eng._decode_fn = keep
    reqs = [Request(uid=i, prompt=p, max_new=te.MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out for r in reqs], torch.stack(logits).numpy()


@pytest.mark.parametrize("plan", list(ENGINE_PLANS))
def test_tp2_engine_matches_tp1_and_the_unsharded_reference(plan):
    jc, tc, _, qp, jq = _tree(plan)
    prompts, res = _engines()[plan]
    toks1, logits1 = _run_tp1(tc, qp, prompts)
    assert res["tokens"] == toks1
    if plan in EXACT_PLANS:
        np.testing.assert_array_equal(res["logits"], logits1)
    else:
        rel = np.abs(res["logits"] - logits1).max() / np.abs(logits1).max()
        assert rel <= TOL_LOGITS, rel
    want, margins, jeng = te._run_jax(jc, jq, prompts)
    te._same_or_near_tie(want, res["tokens"], margins)
    assert (res["decode_steps"], res["prefill_chunks"]) == (jeng.decode_steps,
                                                            jeng.prefill_chunks)
    forwards = res["decode_steps"] + res["prefill_chunks"]
    counts = {}
    for k, v in res["counters"].items():
        if k.startswith("kernel_dispatch_total{"):
            op = k.split("op=")[1].split(",")[0].rstrip("}")
            counts[op] = counts.get(op, 0) + v
    n = tc.n_layers * forwards
    want_counts = {"w2a8_bs": {"lut_gemm_bs_fused": 5 * n, "lut_gemm_bitsliced": 2 * n},
                   "w2a2": {"lut_gemm": 7 * n}, "w2a16": {"dequant_matmul": 7 * n}}
    want_counts["w2a8_bs_g64"] = want_counts["w2a8_bs"]
    assert {k: v for k, v in counts.items() if "attention" not in k} == want_counts[plan]


def test_cli_tp2_serve_equals_tp1_and_halves_the_packed_bytes():
    """``serve_rank`` (what ``--tp 2`` runs on every rank) under w2a8_bs on
    the CPU: every rank's tokens and first-step logits are identical, they
    equal the tp=1 serve's bit for bit, and each rank holds exactly half of
    the packed planes of every role-stamped leaf."""
    args = serve.build_parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--paged", "--device", "cpu",
         "--plan", "w2a8_bs", "--requests", "4", "--gen", "6"])
    res = mesh.run_ranks(serve.serve_rank, 2, args, device="cpu")
    cfg, qparams = serve.prepare(args)
    cap = {}
    engine = serve.make_engine(cfg, qparams, args)
    inner = engine._decode_fn

    def keep(*a):
        out = inner(*a)
        cap.setdefault("logits", out.clone())
        return out

    engine._decode_fn = keep
    one = serve.serve_paged(cfg, qparams, args, engine=engine)
    assert res["ranks_agree"] and res["backend"] == "gloo"
    assert res["tokens"] == [r.out for r in one["requests"]]
    np.testing.assert_array_equal(res["first_logits"], cap["logits"].numpy())
    whole = {p: qw.packed.numel() for p, qw in lm.qweights(qparams).items()}
    total = sum(t.numel() * t.element_size() for t in _tensors(qparams))
    for r in res["ranks"]:
        assert set(r["role_packed_bytes"]) == set(whole)
        assert all(2 * b == whole[p] for p, b in r["role_packed_bytes"].items())
        assert r["weight_bytes"] < total
        assert r["launches"] == res["ranks"][0]["launches"]


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, qlinear.QuantizedWeight):
        yield from (t for t in vars(tree).values() if torch.is_tensor(t))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
