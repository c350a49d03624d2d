"""The port's bit-sliced slice against the JAX reference on the same numpy
inputs: signed bit planes, bit-sliced packed leaves, the plain version of
the fused-prologue kernel (``lut_gemm_bs_fused_plain``) against the
reference's oracle ``ref_lut_gemm_bs_fused`` and its Pallas kernel in
interpret mode, ``dense_serve`` on bit-sliced leaves, the bridge, and the
paged engine under the bit-sliced plans.

Tolerances: per channel the integer core is exact and the epilogue is the
same two f32 products in the same order, so outputs are bit-identical
(bf16 activations included: amax, scale and quotient round to bf16 as in
the reference). With group scales the f32 sum over groups is taken in
another order: 1e-5 relative to the largest output.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduce_for_smoke as jreduce
from repro.core import packing as jpacking, qlinear as jqlinear, qplan as jqplan
from repro.kernels import ref as jref
from repro.kernels.lut_gemm_bitsliced import lut_gemm_bs_fused_pallas
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import packing, qlinear, qplan
from repro_torch.kernels import ref as tref, registry
from repro_torch.kernels.lut_gemm_bitsliced import (lut_gemm_bs_fused_cuda,
                                                    lut_gemm_bs_fused_plain)
from repro_torch.obs import metrics as obs_metrics

import test_torch_engine as te

KEY = jax.random.PRNGKey(0)
RTOL_GROUPED = 1e-5
BS_PLANS = ("w2a8_bs", "w2a8_bs_g64", "w4a8_bs")


def _np(x):
    """JAX array or torch tensor -> numpy; bfloat16 as its 16-bit pattern."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _close(want, got, grouped):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    if grouped:
        np.testing.assert_allclose(got, want, rtol=RTOL_GROUPED,
                                   atol=RTOL_GROUPED * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


def _operands(seed, M, K, N, bits, group, dtype):
    """x (M, K) with an all-zero row (the scale floor) and a row whose amax
    sits in one element, b-bit codes (N, K), scales; as torch and jax."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[:, :8] = np.round(x[:, :8] * 4) / 4               # quotient ties
    if M > 1:
        x[0] = 0.0
    if M > 2:
        x[1] *= 1e-3
        x[1, K // 3] = 40.0
    idx = rng.integers(0, 2 ** bits, (N, K)).astype(np.uint8)
    sc = (rng.random((N,) if group is None else (N, K // group)) * 0.02
          + 0.01).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    return tx, jx, idx, sc


# --------------------------------------------------------------------------- #
# Planes and leaves
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_bitplanes_bit_identical(bits):
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 2 ** bits, (3, 10, 64)).astype(np.uint8)   # stacked
    jp = jpacking.pack_bitplanes_signed(jnp.asarray(idx), bits)
    tp = packing.pack_bitplanes_signed(torch.from_numpy(idx), bits)
    assert tp.shape == (3, bits, 10, 16) and tp.is_contiguous()
    np.testing.assert_array_equal(_np(jp), _np(tp))
    np.testing.assert_array_equal(_np(jpacking.pack_bitplanes(jnp.asarray(idx), bits)),
                                  _np(packing.pack_bitplanes(torch.from_numpy(idx), bits)))
    np.testing.assert_array_equal(packing.unpack_bitplanes_signed(tp, bits).numpy(), idx)
    assert packing.bitplane_coeffs(bits) == jpacking.bitplane_coeffs(bits)
    assert packing.bitplane_packed_len(64) == jpacking.bitplane_packed_len(64)


@pytest.mark.parametrize("plan", BS_PLANS)
def test_bitsliced_leaf_bit_identical(plan):
    """Planes, scales, codebooks and k_padded of a bit-sliced leaf (K=70:
    padded to the plane group or the scale group), with a static scale."""
    rng = np.random.default_rng(len(plan))
    w = (rng.normal(size=(70, 24)) * 0.1).astype(np.float32)
    jq = jqlinear.quantize_weight(jnp.asarray(w), jqplan.get_plan(plan).rules[-1][1],
                                  a_static=0.05)
    tq = qlinear.quantize_weight(torch.from_numpy(w), qplan.get_plan(plan).rules[-1][1],
                                 a_static=0.05)
    assert tq.scheme == "bs" and tq.plut is None and tq.packed.ndim == 3
    for name in ("packed", "codebook", "scales", "a_levels", "a_sc"):
        np.testing.assert_array_equal(_np(getattr(jq, name)), _np(getattr(tq, name)))
    for name in ("bits", "in_features", "out_features", "group_size", "a_bits",
                 "scheme", "kernel", "k_padded"):
        assert getattr(jq, name) == getattr(tq, name), name
    np.testing.assert_array_equal(_np(jq.unpacked_idx()), _np(tq.unpacked_idx()))
    np.testing.assert_array_equal(_np(jqlinear.dequant_weight(jq)),
                                  _np(qlinear.dequant_weight(tq)))


# --------------------------------------------------------------------------- #
# The plain version against the reference's oracle and its Pallas kernel
# --------------------------------------------------------------------------- #

_FUSED_CASES = (
    [(M, b, dt, None, None) for M in (1, 4, 8, 13) for b in (2, 4)
     for dt in ("bfloat16", "float32")]
    + [(M, 2, dt, "static", None) for M in (1, 8) for dt in ("bfloat16", "float32")]
    + [(4, 4, "bfloat16", "rows", None)]
    + [(M, b, "bfloat16", None, 64) for M in (1, 4, 13) for b in (2, 4)]
    + [(4, 2, "float32", "static", 64)])


@pytest.mark.parametrize("M,bits,dtype,a_sc,group", _FUSED_CASES)
def test_plain_fused_matches_oracle_and_pallas_interpret(M, bits, dtype, a_sc, group):
    K, N = 128, 16
    tx, jx, idx, sc = _operands(M * 10 + bits, M, K, N, bits, group, dtype)
    planes = packing.pack_bitplanes_signed(torch.from_numpy(idx), bits)
    jplanes = jnp.asarray(planes.numpy())
    asc = {None: None, "static": np.array([[0.037]], np.float32),
           "rows": np.linspace(0.01, 0.05, M, dtype=np.float32)[:, None]}[a_sc]
    ja = None if asc is None else jnp.asarray(asc)
    ta = None if asc is None else torch.from_numpy(asc)
    kw = dict(a_bits=8, group_size=group)
    want_ref = jref.ref_lut_gemm_bs_fused(jx, jplanes, jnp.asarray(sc), ja,
                                          w_bits=bits, **kw)
    want_pl = lut_gemm_bs_fused_pallas(jx, jplanes, jnp.asarray(sc), ja, bits=bits,
                                       interpret=True, **kw)
    got = lut_gemm_bs_fused_plain(tx, planes, torch.from_numpy(sc), ta, w_bits=bits,
                                  **kw)
    assert got.dtype == torch.float32 and got.shape == (M, N) and got.is_contiguous()
    _close(want_ref, got.numpy(), group is not None)
    _close(want_pl, got.numpy(), group is not None)


@pytest.mark.parametrize("a_bits,bits,group", [(2, 2, None), (4, 4, None),
                                                (4, 2, 64)])
def test_plain_fused_matches_oracle_and_pallas_at_narrow_a_bits(a_bits, bits, group):
    """The plans use a_bits 8; the op takes 2..8, so narrower activation
    codes (other clamp bounds and scale divisor) are held to the reference."""
    M, K, N = 4, 128, 16
    tx, jx, idx, sc = _operands(a_bits * 10 + bits, M, K, N, bits, group, "bfloat16")
    planes = packing.pack_bitplanes_signed(torch.from_numpy(idx), bits)
    jplanes = jnp.asarray(planes.numpy())
    kw = dict(a_bits=a_bits, group_size=group)
    want_ref = jref.ref_lut_gemm_bs_fused(jx, jplanes, jnp.asarray(sc), None,
                                          w_bits=bits, **kw)
    want_pl = lut_gemm_bs_fused_pallas(jx, jplanes, jnp.asarray(sc), None, bits=bits,
                                       interpret=True, **kw)
    got = lut_gemm_bs_fused_plain(tx, planes, torch.from_numpy(sc), None,
                                  w_bits=bits, **kw)
    _close(want_ref, got.numpy(), group is not None)
    _close(want_pl, got.numpy(), group is not None)


@pytest.mark.parametrize("group", [None, 32])
def test_plain_bitsliced_core_is_exact_when_walked_in_chunks(monkeypatch, group):
    """The integer core summed over N in several chunks (the full-width
    memory bound) equals the exact integer product and the reference."""
    rng = np.random.default_rng(5)
    M, K, N, bits = 5, 128, 40, 4
    codes = rng.integers(-128, 128, (M, K)).astype(np.int8)
    idx = rng.integers(0, 2 ** bits, (N, K)).astype(np.uint8)
    sc = None if group is None else \
        (rng.random((N, K // group)) * 0.02 + 0.01).astype(np.float32)
    planes = packing.pack_bitplanes_signed(torch.from_numpy(idx), bits)
    monkeypatch.setattr(tref, "_GATHER_BUDGET", 3 * (K // 4) * M)   # 14 chunks
    got = tref.ref_lut_gemm_bitsliced(
        torch.from_numpy(codes), planes, None if sc is None else torch.from_numpy(sc),
        bits=bits, group_size=group).numpy()
    want = np.asarray(jref.ref_lut_gemm_bitsliced(
        jnp.asarray(codes), jnp.asarray(planes.numpy()),
        None if sc is None else jnp.asarray(sc), bits=bits, group_size=group))
    _close(want, got, group is not None)
    if group is None:
        exact = codes.astype(np.int64) @ (idx.astype(np.int64) - 2 ** (bits - 1)).T
        np.testing.assert_array_equal(got, exact.astype(np.float32))


def test_int16_run_bounds_match_reference():
    for coef_sum in (1, 2, 3, 4, 8, 12):
        for G in (1, 2, 4, 6, 16, 32, 64, 256, 704):
            run = tref._int16_run(coef_sum, G)
            assert run == jref._int16_run(coef_sum, 4, G)
            assert G % run == 0 and (run == 1 or run * coef_sum * 4 * 128 < 2 ** 15)


# --------------------------------------------------------------------------- #
# dense_serve, registry, bridge
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("plan", BS_PLANS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("static", [False, True])
def test_dense_serve_bitsliced_matches_reference(plan, dtype, static):
    """The fused route end to end: K padding (K=70), M padding (15 rows),
    the leaf's static scale or the per-row dynamic one, bias, cast."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(70, 24)) * 0.1).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    x = rng.normal(size=(3, 5, 70)).astype(np.float32)
    a_static = 0.02 if static else None
    jq = jqlinear.quantize_weight(jnp.asarray(w), jqplan.get_plan(plan).rules[-1][1],
                                  a_static=a_static)
    tq = qlinear.quantize_weight(torch.from_numpy(w), qplan.get_plan(plan).rules[-1][1],
                                 a_static=a_static)
    jy = jqlinear.dense_serve(jq, jnp.asarray(x).astype(jnp.dtype(dtype)),
                              bias=jnp.asarray(b).astype(jnp.dtype(dtype)),
                              backend="ref")
    with obs_metrics.scoped(isolate=True) as reg:
        ty = qlinear.dense_serve(tq, torch.from_numpy(x).to(getattr(torch, dtype)),
                                 bias=torch.from_numpy(b).to(getattr(torch, dtype)))
    assert reg.counter_total("kernel_dispatch_total", op="lut_gemm_bs_fused",
                             backend="ref", m_bucket="le16") == 1
    assert ty.shape == (3, 5, 24) and ty.dtype == getattr(torch, dtype)
    if plan == "w2a8_bs_g64":
        np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                                   rtol=2 ** -8 if dtype == "bfloat16" else RTOL_GROUPED,
                                   atol=1e-5)   # bf16: 2^-8, the smallest relative ulp
    else:
        np.testing.assert_array_equal(_np(jy), _np(ty))


def test_fused_op_routes_cpu_tensors_to_plain_and_kernel_refuses_them():
    tx, _, idx, sc = _operands(1, 4, 64, 16, 2, None, "float32")
    ops = (tx, packing.pack_bitplanes_signed(torch.from_numpy(idx), 2),
           torch.from_numpy(sc))
    before = lut_gemm_bs_fused_cuda.launches
    np.testing.assert_array_equal(
        registry.dispatch("lut_gemm_bs_fused", *ops, None, w_bits=2,
                          a_bits=8).numpy(),
        lut_gemm_bs_fused_plain(*ops, w_bits=2).numpy())
    assert lut_gemm_bs_fused_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        lut_gemm_bs_fused_cuda(*ops, w_bits=2)
    with pytest.raises(ValueError, match="CUDA"):
        registry.dispatch("lut_gemm_bs_fused", *ops, None, w_bits=2, backend="cuda")


_TREES = {}


def _bs_setup(plan):
    """(reference config, port config, reference params, packed reference
    tree, the port's tree bridged from it) on the f32 reduced qwen1.5-0.5b
    with two layers and an int8 pool."""
    if plan not in _TREES:
        kw = {"w2a8_bs": dict(w_bits=2, a_bits=8),
              "w2a8_bs_g64": dict(w_bits=2, a_bits=8, group_size=64),
              "w4a8_bs": dict(w_bits=4, a_bits=8)}[plan]
        kw["kernel"] = "lut_gemm_bitsliced"
        jc = dataclasses.replace(jreduce(jget_config("qwen1.5-0.5b")), n_layers=2,
                                 dtype="float32", kv_cache_dtype="int8",
                                 quant=jqplan.make_plan(**kw, backend="ref"))
        tc = dataclasses.replace(reduce_for_smoke(get_config("qwen1.5-0.5b")),
                                 n_layers=2, dtype="float32", kv_cache_dtype="int8",
                                 quant=qplan.make_plan(**kw))
        jparams = jlm.init_params(KEY, jc)
        qp = jlm.quantize_tree(jparams, jc)
        tq = bridge.qparams_from_jax(jax.tree.map(np.asarray, qp), tc, device="cpu")
        _TREES[plan] = (jc, tc, jparams, qp, tq)
    return _TREES[plan]


def test_bridge_carries_bitsliced_tree_bit_for_bit():
    """A quantize_tree'd w2a8_bs tree (stacked superblocks) comes across
    with every layer's (bits, N, K/4) planes, scales and codebooks intact,
    equal to the port's own packing of the same weights; a static a_sc is
    carried where a leaf has one."""
    _, tc, jparams, jq, tq = _bs_setup("w2a8_bs")
    own = qplan.get_plan("w2a8_bs")
    for s in range(tc.n_layers):
        for grp, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_down")):
            jleaf = jq["blocks"]["l0"][grp][name]["qw"]
            tleaf = tq["layers"][s][grp][name]["qw"]
            assert tleaf.scheme == "bs" and tleaf.packed.shape[0] == 2
            for f in ("packed", "scales", "codebook", "a_levels"):
                np.testing.assert_array_equal(np.asarray(getattr(jleaf, f))[s],
                                              _np(getattr(tleaf, f)))
            assert tleaf.plut is None and tleaf.a_sc is None
            w = np.array(jparams["blocks"]["l0"][grp][name]["w"])[s]
            mine = qlinear.quantize_weight(torch.from_numpy(w), own.rules[-1][1])
            np.testing.assert_array_equal(_np(mine.packed), _np(tleaf.packed))
    leaf = jqlinear.quantize_weight(jnp.ones((64, 8)), jqplan.get_plan(
        "w2a8_bs").rules[-1][1], a_static=0.25)
    got = bridge._qw_from(jax.tree.map(np.asarray, leaf), None, "cpu")
    assert got.a_sc is not None and float(got.a_sc) == 0.25


@pytest.mark.parametrize("plan", BS_PLANS)
def test_engine_greedy_tokens_match_reference_under_bitsliced_plans(plan):
    """The port's paged engine against the reference's Engine on the f32
    reduced qwen1.5-0.5b (two layers, int8 pool; f32 for the reason
    test_torch_engine.py gives): the same greedy tokens, and every
    projection of every forward through lut_gemm_bs_fused."""
    jc, tc, _, qp, tq = _bs_setup(plan)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab_size, size=n).astype(np.int32)
               for n in te.PROMPT_LENS]
    want, margins, jeng = te._run_jax(jc, qp, prompts)
    got, m = te._run_port(tc, tq, prompts)
    te._same_or_near_tie(want, got, margins)
    assert (m["decode_steps"], m["prefill_chunks"]) == (jeng.decode_steps,
                                                        jeng.prefill_chunks)
    n = sum(v for k, v in m["metrics"]["counters"].items()
            if k.startswith("kernel_dispatch_total{") and "op=lut_gemm_bs_fused" in k)
    assert n == 7 * tc.n_layers * (m["decode_steps"] + m["prefill_chunks"])
