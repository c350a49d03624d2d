"""The tiling and the rounding order of the two packed-weight GEMM kernels
(csrc/lut_gemm.cu, csrc/dequant_matmul.cu, csrc/dense_common.cuh) on the
CPU: ``dense_partition`` covers K exactly once within the kernels' limits,
and the dequant kernel's plain version (``ref.py::tile_order_matmul``)
equals the reference oracle within f32 rounding and a scalar emulation of
the kernel's schedule bit for bit. The kernels against their plain versions
on the card are in test_torch_kernels_gpu.py.

Tolerances: the tile-order sum rounds in another order than the oracle's
matmul: 1e-5 relative, plus 1e-5 of the largest output absolute (f32 sums
of up to 2816 products of unit-scale activations with levels up to 8,
where outputs near zero carry the cancelled terms' rounding). Against the
scalar emulation and between the exact and the rounding path:
bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro_torch.core import packing, quant
from repro_torch.kernels import ref as tref
from repro_torch.kernels.lut_dequant_matmul import dequant_matmul_plain
from repro_torch.kernels.lut_gemm import (DENSE_A_TILE_BYTES, DENSE_COL_TILES,
                                          DENSE_MAX_CLUSTER, DENSE_ROW_TILE,
                                          DENSE_S_TILE_BYTES, DENSE_W_TILE_BYTES,
                                          dense_partition, dense_rounds, dense_unit)

RTOL = 1e-5
# shared memory a block may take with two blocks an SM (kDenseMinBlocks)
# of 228 KB, 1 KB of each reserved
SMEM_PER_BLOCK = 113 * 1024
QWEN = ((1024, 1024), (1024, 2816), (2816, 1024))
# the K slices (row role) and column slices (col role) --tp 2 gives
TP2 = ((512, 1024), (1408, 1024), (1024, 512), (1024, 1408))


def _dq_operands(seed, M, K, N, bits, group, dtype):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dtype)
    w_idx = rng.integers(0, 2 ** bits, size=(N, K)).astype(np.uint8)
    cb = quant.uniform_codebook(bits).levels.float()
    sc = rng.uniform(0.01, 0.1, size=(N,) if group is None else (N, K // group))
    wp = packing.pack(torch.from_numpy(w_idx), bits)
    return a, wp, cb, torch.from_numpy(sc.astype(np.float32))


def _smem_bytes(MT, NT, C, kpr, w_bits, a_bits, G, table_floats):
    """csrc/dense_common.cuh::dense_layout's total, in codes (w2a2 walks
    code pairs: the same bytes): the k-lanes' sums get their own space
    where the budget holds it, else they reuse the tiles'."""
    r16 = lambda x: -(-x // 16) * 16                         # noqa: E731
    wt = r16(NT * ((kpr * w_bits // 32) | 1) * 4)
    at = r16(MT * kpr * a_bits // 8)
    st = r16(NT * (-(-kpr // G) + 1) * 4) if G else 0
    red = 8 * MT * NT * 4
    rest = r16(table_floats * 4) + r16(C * -(-MT * NT // C) * 4)
    if wt + at + st + rest + red <= SMEM_PER_BLOCK:
        return wt + at + st + rest + red
    return r16(max(wt + at + st, red)) + rest


def _check_tiling(M, N, K, w_bits, a_bits, G, part, table_floats):
    MT, NT, C, kpr = part
    unit = dense_unit(w_bits)
    rounds = dense_rounds(K, C, kpr)
    assert 1 <= MT <= DENSE_ROW_TILE and -(-M // MT) == -(-M // DENSE_ROW_TILE)
    assert NT in DENSE_COL_TILES and 1 <= C <= DENSE_MAX_CLUSTER
    assert kpr >= unit and kpr % unit == 0
    # the windows cover K exactly once: no round past K, none short of it
    assert C * kpr * (rounds - 1) < K <= C * kpr * rounds
    if rounds == 1:                        # no rank is left without work
        assert (C - 1) * kpr < K
    assert NT * kpr * w_bits // 8 <= DENSE_W_TILE_BYTES
    assert MT * kpr * a_bits // 8 <= DENSE_A_TILE_BYTES
    if G:
        assert NT * (-(-kpr // G) + 1) * 4 <= DENSE_S_TILE_BYTES
    assert MT * NT <= DENSE_ROW_TILE * DENSE_COL_TILES[0]
    assert _smem_bytes(MT, NT, C, kpr, w_bits, a_bits, G, table_floats) <= SMEM_PER_BLOCK


# (w_bits, a_bits as staged, group, table floats): lut_gemm's four widths
# (w2a2's pair table has 256 entries) and dequant_matmul's bf16 / f32 rows
_OPS = [(2, 2, None, 256), (2, 2, 64, 256), (4, 8, None, 4096), (2, 8, None, 1024),
        (4, 4, None, 256), (2, 16, None, 16 + 128), (2, 16, 128, 16 + 128),
        (4, 16, None, 16 + 128), (2, 32, None, 16 + 128), (4, 32, 64, 16 + 128)]


@pytest.mark.parametrize("w_bits,a_bits,group,table", _OPS)
def test_dense_partition_covers_k_once_at_the_served_shapes(w_bits, a_bits, group,
                                                             table):
    """Every shape of chip_smoke.py's phase 4 (qwen's projections, M 1, 4,
    32, 128), the --tp 2 slices, and every M from 1 to 128 at 1024 x 2816."""
    shapes = [(M, K, N) for K, N in QWEN + TP2 for M in (1, 4, 32, 128)]
    shapes += [(M, 1024, 2816) for M in range(1, 129)]
    for M, K, N in shapes:
        part = dense_partition(M, N, K, w_bits, a_bits, group)
        _check_tiling(M, N, K, w_bits, a_bits, group, part, table)


def test_dense_partition_decode_shapes_take_short_windows_on_few_ranks():
    """At M 1 and 4 the chosen tiling takes 64-column tiles, K windows of
    256-512 codes on at most 6 ranks, and at most two blocks an SM; more
    rows take one round of windows where that keeps two blocks an SM."""
    for M in (1, 4):
        for K, N in QWEN:
            for w_bits, a_bits in ((2, 2), (4, 8), (2, 16), (4, 16)):
                MT, NT, C, kpr = dense_partition(M, N, K, w_bits, a_bits)
                assert NT == 64 and C <= 6 and 256 <= kpr <= 512, (M, K, N, C, kpr)
                assert -(-N // NT) * C <= 2 * 132
    assert dense_partition(4, 2816, 1024, 2, 2) == (4, 64, 4, 256)
    assert dense_partition(4, 1024, 2816, 2, 16) == (4, 64, 6, 512)
    assert dense_partition(32, 1024, 2816, 4, 16) == (8, 64, 3, 960)
    assert dense_partition(128, 2816, 1024, 2, 16) == (8, 128, 1, 1024)


@pytest.mark.parametrize("M,K,N,w_bits,group", [
    (5, 1412, 1003, 4, None), (3, 4160, 64, 4, 64), (17, 5000, 200, 2, None),
    (2, 13440, 4096, 2, 4), (2, 2600, 130, 2, 4), (128, 2816, 1024, 2, 64)])
def test_dense_partition_ragged_and_small_groups(M, K, N, w_bits, group):
    for a_bits in (2 if w_bits == 2 else 4, 8, 16, 32):
        for ranks in (None, 1, 3):
            for cols in (None, 64, 128):
                try:
                    part = dense_partition(M, N, K, w_bits, a_bits, group,
                                           ranks=ranks, cols=cols)
                except ValueError:
                    # a forced 128-column tile with groups of 4: no window fits
                    assert cols == 128 and group == 4
                    continue
                _check_tiling(M, N, K, w_bits, a_bits, group, part, 16 + part[1])


def test_dense_partition_refuses_bad_requests():
    with pytest.raises(ValueError):
        dense_partition(4, 1024, 1024, 2, 2, cols=32)
    with pytest.raises(ValueError):
        dense_partition(4, 1024, 256, 2, 2, ranks=3)       # 2 windows only
    with pytest.raises(ValueError):
        dense_partition(0, 1024, 1024, 2, 2)


def _scalar_kernel_order(a, levels, scales, ranks, kpr, word, group):
    """The CUDA dequant kernel's schedule, one f32 operation at a time in
    numpy: rank c takes windows c, c + ranks, ...; k-lane j the words j,
    j + 8, ... of a window; each block of 8 codes is summed product by
    product (codes past K skipped), times its group's scale where the group
    is a multiple of 8 codes (other groups fold into the levels), and added
    into the lane's sum; the 8 lanes' sums meet in a pairwise tree, the
    ranks' partials in rank order, then the per-channel scale."""
    f32 = np.float32
    a = a.float().numpy()
    w = levels.numpy().astype(np.float32)
    sc = scales.numpy()
    if group is not None and group % 8:
        w = (w * np.repeat(sc, group, axis=1)).astype(np.float32)
    M, K = a.shape
    N = w.shape[0]
    rounds = -(-K // (ranks * kpr))
    out = np.zeros((M, N), dtype=np.float32)
    for m in range(M):
        for n in range(N):
            total = f32(0)
            for c in range(ranks):
                lanes = [f32(0)] * 8
                for t in range(rounds):
                    lo = min(K, (t * ranks + c) * kpr)
                    hi = min(K, lo + kpr)
                    nwords = -(-(hi - lo) // word)
                    for j in range(8):
                        acc = lanes[j]
                        for wi in range(j, nwords, 8):
                            for b in range(0, word, 8):
                                part = f32(0)
                                for q in range(b, b + 8):
                                    k = lo + wi * word + q
                                    if k < hi:
                                        part = f32(part + f32(f32(a[m, k]) * f32(w[n, k])))
                                if group is not None and group % 8 == 0:
                                    kb = min(lo + wi * word + b, K - 1)
                                    part = f32(part * f32(sc[n, kb // group]))
                                acc = f32(acc + part)
                        lanes[j] = acc
                while len(lanes) > 1:
                    lanes = [f32(lanes[i] + lanes[i + 1]) for i in range(0, len(lanes), 2)]
                total = lanes[0] if c == 0 else f32(total + lanes[0])
            out[m, n] = total if group is not None else f32(total * sc[n])
    return torch.from_numpy(out)


@pytest.mark.parametrize("M,K,N,bits,group,dtype,ranks,cols", [
    (2, 256, 5, 2, None, torch.bfloat16, None, None),
    (3, 700, 4, 4, None, torch.float32, 3, 64),      # K off the word, 3 ranks
    (2, 200, 3, 2, 8, torch.bfloat16, 2, None),      # group of 8, ragged window
    (1, 384, 6, 4, 64, torch.float32, 1, 128),       # one rank over several words
    (2, 2600, 3, 2, 4, torch.bfloat16, None, 64),    # small groups, 8 ranks
    (3, 4200, 2, 2, None, torch.float32, 1, 128),    # several rounds
])
def test_tile_order_equals_scalar_emulation_of_the_kernel(M, K, N, bits, group, dtype,
                                                          ranks, cols):
    a, wp, cb, sc = _dq_operands(M * K + N, M, K, N, bits, group, dtype)
    _, _, C, kpr = dense_partition(M, N, K, bits, 16 if dtype == torch.bfloat16 else 32,
                                   group, ranks=ranks, cols=cols)
    if ranks == 1 and K > 4000:
        assert dense_rounds(K, C, kpr) > 1
    got = dequant_matmul_plain(a, wp, cb, sc, bits=bits, group_size=group,
                               ranks=ranks, cols=cols)
    levels = tref._dequant(wp, cb, sc, bits, None)
    want = _scalar_kernel_order(a, levels, sc, C, kpr, 32 // bits, group)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


_TILE_CASES = [(M, K, N, b, g, dt, r)
               for (M, K, N) in ((1, 1024, 96), (4, 1412, 1003), (9, 2816, 40),
                                 (33, 512, 130))
               for (b, g) in ((2, None), (2, 128), (4, None), (4, 4))
               for dt in (torch.bfloat16, torch.float32)
               for r in (None, 1)
               if g is None or K % g == 0]


@pytest.mark.parametrize("M,K,N,bits,group,dtype,ranks", _TILE_CASES)
def test_tile_order_dequant_matmul_matches_oracles(M, K, N, bits, group, dtype, ranks):
    """The plain dequant version (tile order) against the port's and the
    reference's ref_dequant_matmul, within f32 rounding."""
    a, wp, cb, sc = _dq_operands(M + K + N, M, K, N, bits, group, dtype)
    got = dequant_matmul_plain(a, wp, cb, sc, bits=bits, group_size=group,
                               ranks=ranks).numpy()
    want = tref.ref_dequant_matmul(a, wp, cb, sc, bits, group).numpy()
    ja = jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want_j = np.asarray(jref.ref_dequant_matmul(ja, jnp.asarray(wp.numpy()),
                                                jnp.asarray(cb.numpy()),
                                                jnp.asarray(sc.numpy()), bits, group))
    assert got.dtype == np.float32 and got.shape == (M, N)
    atol = RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got, want_j, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("group", [None, 64, 4])
def test_tile_order_in_chunks_gives_the_same_bits(monkeypatch, group):
    """The replay walks its block sums a chunk at a time where they would
    not fit the budget: the same bits as all at once."""
    a, wp, cb, sc = _dq_operands(17, 5, 2816, 96, 2, group, torch.bfloat16)
    want = dequant_matmul_plain(a, wp, cb, sc, bits=2, group_size=group, ranks=2)
    monkeypatch.setattr(tref, "_BLOCK_BUDGET", 5 * 96 * 16 * 3)     # 3 blocks a chunk
    got = dequant_matmul_plain(a, wp, cb, sc, bits=2, group_size=group, ranks=2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_bf16_products_with_integer_levels_are_exact_in_f32():
    """The premise of the dequant kernel's fused multiply-add path (bf16
    rows, per-channel scales, a codebook of integers of at most 16 bits):
    every product is exact in f32, so fusing gives the plain version's
    bits. Checked against float64 over every bf16 exponent and mantissa
    near 1 and the extreme levels."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32) *
                         np.exp2(rng.integers(-60, 60, size=4096)).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    levels = torch.tensor([-65536.0, -65535.0, -8.0, -2.0, -1.0, 1.0, 7.0, 255.0, 65535.0])
    prod32 = (x[:, None] * levels[None, :]).double()
    prod64 = x.double()[:, None] * levels.double()[None, :]
    np.testing.assert_array_equal(prod32.numpy(), prod64.numpy())
