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
another order: 1e-5 relative to the largest output. The walk sums the
groups in the oracle's ascending order, so it is held bit for bit to the
oracle in every case, and to the Pallas kernels at the tolerances above.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduce_for_smoke as jreduce
from repro.core import packing as jpacking, qlinear as jqlinear, qplan as jqplan
from repro.kernels import ref as jref
from repro.kernels.lut_gemm_bitsliced import (lut_gemm_bitsliced_pallas,
                                              lut_gemm_bs_fused_pallas)
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import packing, qlinear, qplan
from repro_torch.device import CARD_SMS
from repro_torch.kernels import lut_gemm_bitsliced as BS, ref as tref, registry
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
# The kernels' walk and their tiling
# --------------------------------------------------------------------------- #

# (label, M, K, N, bits, group): the card's edges (chip_smoke.py
# BITSLICED_EDGES) at their own shapes
WALK_EDGES = (
    ("M 1, K of one pattern group", 1, 4, 16, 2, None),
    ("one group per row", 4, 1024, 256, 2, 1024),
    ("N off the column tile", 4, 1024, 1003, 2, None),
    ("K off the segment", 3, 1412, 64, 4, None),
    ("one pattern group per scale group", 5, 512, 40, 2, 4),
    ("group spans segments", 32, 2048, 72, 4, 512),
)


def _two_step_operands(seed, M, K, N, bits, group):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-128, 128, (M, K)).astype(np.int8)
    idx = rng.integers(0, 2 ** bits, (N, K)).astype(np.uint8)
    sc = None if group is None else \
        (rng.random((N, K // group)) * 0.02 + 0.01).astype(np.float32)
    return codes, idx, sc


def _check_two_step_walk(M, K, N, bits, group, C, seed):
    codes, idx, sc = _two_step_operands(seed, M, K, N, bits, group)
    planes = packing.pack_bitplanes_signed(torch.from_numpy(idx), bits)
    tsc = None if sc is None else torch.from_numpy(sc)
    if C is not None:
        assert BS.bs_partition(M, N, K, group, ranks=C)[2] == C
    got = BS.lut_gemm_bitsliced_walk(torch.from_numpy(codes), planes, tsc, bits=bits,
                                     group_size=group, ranks=C)
    assert got.dtype == torch.float32 and got.shape == (M, N) and got.is_contiguous()
    want = tref.ref_lut_gemm_bitsliced(torch.from_numpy(codes), planes, tsc, bits=bits,
                                       group_size=group)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jargs = (jnp.asarray(codes), jnp.asarray(planes.numpy()),
             None if sc is None else jnp.asarray(sc))
    _close(jref.ref_lut_gemm_bitsliced(*jargs, bits=bits, group_size=group), got.numpy(),
           group is not None)
    _close(lut_gemm_bitsliced_pallas(*jargs, bits=bits, group_size=group, interpret=True),
           got.numpy(), group is not None)


@pytest.mark.parametrize("group", [None, 64])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_two_step_walk_matches_oracle_and_pallas_at_each_cluster_size(C, bits, group):
    """K = 1984 (31 segments of 64 codes): C = 2, 3 and 8 each leave a
    ragged last rank; the oracle and the Pallas kernel agree."""
    _check_two_step_walk(4, 1984, 40, bits, group, C, seed=C * 10 + bits)


@pytest.mark.parametrize("label,M,K,N,bits,group", WALK_EDGES,
                         ids=[e[0] for e in WALK_EDGES])
def test_two_step_walk_matches_oracle_and_pallas_at_the_edges(label, M, K, N, bits,
                                                              group):
    _check_two_step_walk(M, K, N, bits, group, None, seed=len(label))


@pytest.mark.parametrize("M,C,dtype,a_sc,group", [
    (4, None, "bfloat16", None, None), (4, 3, "float32", None, None),
    (13, 8, "bfloat16", None, None), (1, 2, "bfloat16", "static", None),
    (4, 3, "bfloat16", None, 64), (13, 8, "float32", "rows", 64)])
@pytest.mark.parametrize("bits", [2, 4])
def test_fused_walk_matches_oracle_and_pallas(M, C, dtype, a_sc, group, bits):
    """The rank-sliced amax, quantization and epilogue: an all-zero row, a
    row whose amax sits in one element far from the first rank, quotient
    ties; grouped outputs bit for bit with the oracle (ascending groups),
    within 1e-5 of the Pallas kernel."""
    K, N = 1984, 40
    tx, jx, idx, sc = _operands(M * 7 + bits, M, K, N, bits, group, dtype)
    if M > 2:
        tx[1, K - 3] = 50.0                 # in the last rank's slice
        jx = jx.at[1, K - 3].set(50.0)
    planes = packing.pack_bitplanes_signed(torch.from_numpy(idx), bits)
    asc = {None: None, "static": np.array([[0.037]], np.float32),
           "rows": np.linspace(0.01, 0.05, M, dtype=np.float32)[:, None]}[a_sc]
    ta = None if asc is None else torch.from_numpy(asc)
    kw = dict(a_bits=8, group_size=group)
    got = BS.lut_gemm_bs_fused_walk(tx, planes, torch.from_numpy(sc), ta, w_bits=bits,
                                    ranks=C, **kw)
    want = tref.ref_lut_gemm_bs_fused(tx, planes, torch.from_numpy(sc), ta, w_bits=bits,
                                      **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    want_pl = lut_gemm_bs_fused_pallas(jx, jnp.asarray(planes.numpy()), jnp.asarray(sc),
                                       None if asc is None else jnp.asarray(asc),
                                       bits=bits, interpret=True, **kw)
    _close(want_pl, got.numpy(), group is not None)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("code", [-128, 127])
def test_walk_is_exact_at_the_widest_packed_sums(bits, code):
    """Every code -128 (or 127) against every pattern 0xF: each packed
    entry is 0 (or 1020), a 16-group run the most a lane can hold; at w4
    the high plane's coefficient is -8. With the 16-bit wrap emulated, a
    run eight times longer would overflow its lane and the walk would
    disagree with the oracle."""
    M, K, N = 4, 1024, 48
    codes = torch.full((M, K), code, dtype=torch.int8)
    idx = torch.full((N, K), 2 ** (bits - 1) - 1, dtype=torch.uint8)
    planes = packing.pack_bitplanes_signed(idx, bits)
    assert bool((planes == 0xF).all())
    want = tref.ref_lut_gemm_bitsliced(codes, planes, bits=bits)
    exact = float(code * K * -1)                  # w = sum_p coef_p = -1
    assert bool((want == exact).all())
    for C in (1, 3, 8):
        got = BS.lut_gemm_bitsliced_walk(codes, planes, bits=bits, ranks=C)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_walk_wraps_a_run_too_long_for_its_lane(monkeypatch):
    codes = torch.full((1, 1024), 127, dtype=torch.int8)
    planes = packing.pack_bitplanes_signed(torch.full((8, 1024), 1, dtype=torch.uint8), 2)
    want = tref.ref_lut_gemm_bitsliced(codes, planes, bits=2)
    monkeypatch.setattr(BS, "BS_SEG", 128)         # 128 * 1020 > 2^16 - 1
    got = BS.lut_gemm_bitsliced_walk(codes, planes, bits=2, ranks=1)
    assert not torch.equal(got, want)


_PARTITION_SHAPES = (
    [(M, K, N) for M in (1, 4, 32) for K, N in ((1024, 1024), (1024, 2816), (2816, 1024),
                                                (512, 1024), (1408, 1024))]
    + [(M, K, N) for M in (1, 4) for K, N in ((4096, 4096), (4096, 13440),
                                              (13440, 4096))]
    + [(M, K, N) for _, M, K, N, _, _ in WALK_EDGES]
    + [(128, 2816, 1024), (512, 13440, 4096), (3, 72, 24), (9, 96, 40)])


@pytest.mark.parametrize("group", [None, 4, 32, 64, 512])
def test_bs_partition_cuts_whole_segments_and_scale_groups(group):
    for M, K, N in _PARTITION_SHAPES:
        if group is not None and K % group:
            continue
        MT, NT, C, kpr = BS.bs_partition(M, N, K, group)
        assert MT in BS.BS_ROW_TILES and MT >= min(M, 8), (M, MT)
        assert NT in BS.BS_COL_TILES and 1 <= C <= BS.BS_MAX_CLUSTER
        assert kpr % (4 * BS.BS_SEG) == 0 and (C - 1) * kpr < K
        rounds = BS.bs_rounds(K, C, kpr)
        assert K <= rounds * C * kpr < K + C * kpr
        if group is None:
            assert rounds == 1
        else:
            assert kpr % group == 0, (M, K, N, group, kpr)   # no group straddles ranks
            # several rounds only where one round's partials would not fit
            unit = math.lcm(4 * BS.BS_SEG, group)
            one_round = -(-K // (C * unit)) * unit
            assert rounds == 1 or BS._partials_bytes(
                MT, BS.BS_COL_TILES[-1], C, one_round, group) > BS.BS_PART_BYTES, \
                (M, K, N, group)
        if (K, group) == (13440, 4):             # codeqwen's w_down in groups of 4
            assert rounds > 1
        assert BS._partials_bytes(MT, NT, C, kpr, group) <= BS.BS_PART_BYTES
        blocks = -(-N // NT) * -(-M // MT) * C
        if C > 1:                    # C grows only while every cluster fits at once
            assert blocks <= BS.BS_BLOCKS_PER_SM * CARD_SMS or group is not None


@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("K,N", [(1024, 1024), (1024, 2816), (2816, 1024), (512, 1024),
                                 (1408, 1024), (4096, 13440), (13440, 4096)])
def test_bs_partition_keeps_wide_tiles_and_every_cluster_resident(M, K, N):
    """Per channel the tile is 128 columns wide, and C is the largest that
    keeps every cluster resident at once (up to 8, no rank empty)."""
    MT, NT, C, kpr = BS.bs_partition(M, N, K)
    tiles = -(-N // NT) * -(-M // MT)
    assert NT == 128
    assert C == 1 or tiles * C <= BS.BS_BLOCKS_PER_SM * CARD_SMS
    assert C == BS.BS_MAX_CLUSTER or C == -(-K // 64) \
        or tiles * (C + 1) > BS.BS_BLOCKS_PER_SM * CARD_SMS


def test_bs_partition_reads_static_shapes_only(monkeypatch):
    """The walk (and each wrapper) asks bs_partition with plain ints taken
    from the shapes, never a tensor, and the answer depends on nothing
    else: the same call always gives the same tiling."""
    seen = []
    real = BS.bs_partition

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(BS, "bs_partition", spy)
    codes, idx, _ = _two_step_operands(0, 4, 1024, 40, 2, None)
    planes = packing.pack_bitplanes_signed(torch.from_numpy(idx), 2)
    BS.lut_gemm_bitsliced_walk(torch.from_numpy(codes), planes, bits=2)
    BS.lut_gemm_bitsliced_walk(torch.from_numpy(codes), planes, bits=2)
    assert seen == [((4, 40, 1024, None), {"ranks": None, "cols": None})] * 2
    assert all(type(v) is int or v is None for v in seen[0][0])
    with pytest.raises(ValueError, match="multiple"):
        real(4, 40, 1022)
    with pytest.raises(ValueError, match="ranks"):
        real(4, 40, 1024, ranks=9)
    with pytest.raises(ValueError, match="cols"):
        real(4, 40, 1024, cols=48)
    monkeypatch.setattr(BS, "BS_PART_BYTES", 4096)      # one 16-group window: 8 KB
    with pytest.raises(ValueError, match="window"):
        real(4, 4096, 13440, 4)


@pytest.mark.parametrize("group,budget", [(4, None), (64, 1024), (4, 8192)])
def test_walk_in_several_rounds_matches_oracle(monkeypatch, group, budget):
    """Small scale groups over a long K (codeqwen's w_down, 13440 in groups
    of 4) do not fit one round's partials: the windows shrink and the ranks
    walk K in rounds, the terms still added in ascending group order. A
    smaller partial budget forces rounds at K = 1984 too. The two-step walk
    is bit for bit the oracle, the fused walk too (grouped: ascending)."""
    M, N = 3, 40
    K = 13440 if budget is None else 1984
    if budget is not None:
        monkeypatch.setattr(BS, "BS_PART_BYTES", budget)
    MT, NT, C, kpr = BS.bs_partition(M, N, K, group)
    assert BS.bs_rounds(K, C, kpr) > 1, (MT, NT, C, kpr)
    codes, idx, sc = _two_step_operands(K + group, M, K, N, 2, group)
    planes = packing.pack_bitplanes_signed(torch.from_numpy(idx), 2)
    tc, tsc = torch.from_numpy(codes), torch.from_numpy(sc)
    got = BS.lut_gemm_bitsliced_walk(tc, planes, tsc, bits=2, group_size=group)
    want = tref.ref_lut_gemm_bitsliced(tc, planes, tsc, bits=2, group_size=group)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    _close(jref.ref_lut_gemm_bitsliced(jnp.asarray(codes), jnp.asarray(planes.numpy()),
                                       jnp.asarray(sc), bits=2, group_size=group),
           got.numpy(), True)
    x = torch.from_numpy(np.random.default_rng(K).standard_normal((M, K))
                         .astype(np.float32)).to(torch.bfloat16)
    kw = dict(w_bits=2, a_bits=8, group_size=group)
    np.testing.assert_array_equal(
        BS.lut_gemm_bs_fused_walk(x, planes, tsc, **kw).numpy(),
        tref.ref_lut_gemm_bs_fused(x, planes, tsc, **kw).numpy())


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
