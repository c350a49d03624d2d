"""The tiling and the rounding order of the two expert GEMM kernels
(csrc/expert_gemm.cu on the tiled walk of csrc/dense_common.cuh) on the
CPU: ``expert_partition`` covers K exactly once within the kernels' limits
at every shape the expert ops take, the dequant plain version (the
replay, ``ref.py::tile_order_matmul`` with a leading expert axis) equals
the one-expert replay expert by expert bit for bit and the oracles within
f32 rounding, and both plain versions zero exactly the experts that
``active`` leaves out. The kernels against their plain versions on the
card are in test_torch_moe_gpu.py; the plain versions against the
reference's Pallas kernels in test_torch_moe.py.

Tolerances: expert by expert, and between chunkings of the replay:
bit-identical. Against the oracle (another summation order): 1e-5
relative, plus 1e-5 of the largest output absolute.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing, quant
from repro_torch.core.lut import product_lut
from repro_torch.kernels import ref as tref
from repro_torch.kernels.expert_gemm import (expert_dequant_matmul_plain,
                                             expert_lut_gemm_plain)
from repro_torch.kernels.lut_gemm import (DENSE_A_TILE_BYTES, DENSE_COL_TILES,
                                          DENSE_MAX_CLUSTER, DENSE_ROW_TILE,
                                          DENSE_S_TILE_BYTES, DENSE_W_TILE_BYTES,
                                          dense_partition, dense_rounds, dense_unit,
                                          expert_partition)

RTOL = 1e-5


def _dq_operands(seed, E, M, K, N, bits, group, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(E, M, K)).astype(np.float32)).to(dtype)
    w_idx = rng.integers(0, 2 ** bits, size=(E, N, K)).astype(np.uint8)
    cb = quant.uniform_codebook(bits).levels.float()
    sc = rng.uniform(0.01, 0.1, size=(E, N) if group is None else (E, N, K // group))
    return (x, packing.pack(torch.from_numpy(w_idx), bits), cb,
            torch.from_numpy(sc.astype(np.float32)))


# (E, M, K, N, bits, group, dtype, ranks, cols): moonshot's decode shape cut
# in width, rows off the row tile (5, 9), N off the column tile, K off the
# window and off a 16-byte piece (1400, 40), groups of 8 and of all of K,
# forced cluster sizes and column tiles, several rounds
_REPLAY = [
    (6, 4, 2048, 40, 2, None, torch.bfloat16, None, None),
    (3, 5, 1400, 33, 2, None, torch.float32, None, None),
    (4, 9, 512, 17, 4, 8, torch.bfloat16, None, None),
    (2, 3, 40, 17, 2, None, torch.bfloat16, None, None),
    (3, 4, 1024, 24, 2, 64, torch.float32, 3, 64),
    (2, 16, 2048, 12, 2, 2048, torch.bfloat16, 1, 128),
    (2, 2, 4200, 9, 4, None, torch.bfloat16, 1, 128),
    (5, 1, 768, 70, 4, 4, torch.float32, 2, None),
]


@pytest.mark.parametrize("E,M,K,N,bits,group,dtype,ranks,cols", _REPLAY)
def test_expert_replay_equals_tile_order_expert_by_expert(E, M, K, N, bits, group,
                                                          dtype, ranks, cols):
    """The batched replay (every expert at once) gives, expert by expert,
    the bits of the one-expert replay on expert_partition's tiling."""
    x, wp, cb, sc = _dq_operands(E * K + N, E, M, K, N, bits, group, dtype)
    x[E // 2, M // 2:] = 0                  # unfilled capacity rows
    a_bits = 16 if dtype == torch.bfloat16 else 32       # the rows as the kernel stages them
    _, _, C, kpr = expert_partition(E, M, N, K, bits, a_bits, group, ranks=ranks, cols=cols)
    got = expert_dequant_matmul_plain(x, wp, cb, sc, bits=bits, group_size=group,
                                      ranks=ranks, cols=cols)
    assert got.shape == (E, M, N) and got.dtype == torch.float32 and got.is_contiguous()
    for e in range(E):
        want = tref.tile_order_dequant_matmul(x[e], wp[e], cb, sc[e], bits, group,
                                              ranks=C, k_per_rank=kpr)
        np.testing.assert_array_equal(got[e].numpy(), want.numpy())
    oracle = tref.ref_expert_dequant_matmul(x, wp, cb, sc, bits, group).numpy()
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL,
                               atol=RTOL * float(np.abs(oracle).max()))


@pytest.mark.parametrize("group", [None, 64, 4])
def test_expert_replay_in_chunks_gives_the_same_bits(monkeypatch, group):
    """The replay walks its block sums a chunk at a time where they would
    not fit the budget: the same bits as all at once, expert axis and all."""
    x, wp, cb, sc = _dq_operands(5, 3, 5, 2816, 40, 2, group, torch.bfloat16)
    want = expert_dequant_matmul_plain(x, wp, cb, sc, bits=2, group_size=group, ranks=2)
    monkeypatch.setattr(tref, "_BLOCK_BUDGET", 2 * 8 * 3 * 5 * 40 * 3)   # 3 blocks a chunk
    got = expert_dequant_matmul_plain(x, wp, cb, sc, bits=2, group_size=group, ranks=2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _check_tiling(E, M, N, K, w_bits, a_bits, G, part):
    MT, NT, C, kpr = part
    unit = dense_unit(w_bits)
    rounds = dense_rounds(K, C, kpr)
    assert 1 <= MT <= DENSE_ROW_TILE and -(-M // MT) == -(-M // DENSE_ROW_TILE)
    assert NT in DENSE_COL_TILES and 1 <= C <= DENSE_MAX_CLUSTER
    assert kpr >= unit and kpr % unit == 0
    assert C * kpr * (rounds - 1) < K <= C * kpr * rounds
    if rounds == 1:                        # no rank is left without work
        assert (C - 1) * kpr < K
    assert NT * kpr * w_bits // 8 <= DENSE_W_TILE_BYTES
    assert MT * kpr * a_bits // 8 <= DENSE_A_TILE_BYTES
    if G:
        assert NT * (-(-kpr // G) + 1) * 4 <= DENSE_S_TILE_BYTES
    assert E * -(-M // MT) <= 65535        # grid z


def test_expert_partition_covers_k_once_over_the_parents_domain():
    """Every shape the expert ops took before their tiling existed: E 1 to
    64, M 1 to 32, ragged N and K, groups of 8 up to all of K, bf16 and f32
    rows (dequant) and packed codes (LUT), w2 and w4."""
    shapes = [(E, M, K, N) for E in (1, 2, 3, 8, 64) for M in (1, 4, 5, 9, 16, 32)
              for K, N in ((2048, 1408), (1408, 2048), (40, 17), (1400, 1003),
                           (64, 8), (200, 33))]
    for E, M, K, N in shapes:
        for bits in (2, 4):
            f = packing.PACK_FACTOR[bits]
            if K % f:
                continue
            groups = [None] + [G for G in (8, 64, K) if K % G == 0 and G % f == 0]
            for G in groups:
                for a_bits in (bits, 16, 32):
                    part = expert_partition(E, M, N, K, bits, a_bits, G)
                    _check_tiling(E, M, N, K, bits, a_bits, G, part)


def test_expert_partition_at_moonshot_takes_one_window_without_a_cluster():
    """At moonshot-v1-16b-a3b's expert shapes the 64 experts' column tiles
    fill the card many times over: C 1, and at decode (M 4, w2) the whole
    K in one window of a 64-column tile (one DRAM round trip, no merge);
    one expert is dense_partition's call."""
    for K, N in ((2048, 1408), (1408, 2048)):
        for a_bits in (2, 16, 32):
            assert expert_partition(64, 4, N, K, 2, a_bits) == (4, 64, 1, K)
        assert expert_partition(64, 4, N, K, 2, 16, 64) == (4, 64, 1, K)
        assert expert_partition(64, 4, N, K, 4, 16)[2] == 1
    assert expert_partition(64, 16, 1408, 2048, 2, 16) == (8, 128, 1, 1024)
    for M in (1, 4, 32):
        assert expert_partition(1, M, 1408, 2048, 2, 16) == \
            dense_partition(M, 1408, 2048, 2, 16)
    with pytest.raises(ValueError):
        expert_partition(0, 4, 1408, 2048, 2, 16)
    with pytest.raises(ValueError):
        expert_partition(64, 4, 1408, 2048, 2, 16, cols=32)


@pytest.mark.parametrize("flag_dtype", [torch.bool, torch.uint8])
def test_plain_versions_zero_exactly_the_flagged_experts(flag_dtype):
    E, M, K, N = 5, 4, 256, 24
    active = torch.tensor([1, 0, 1, 1, 0], dtype=flag_dtype)
    on = active.bool()
    x, wp, cb, sc = _dq_operands(3, E, M, K, N, 2, None, torch.bfloat16)
    full = expert_dequant_matmul_plain(x, wp, cb, sc, bits=2)
    got = expert_dequant_matmul_plain(x, wp, cb, sc, bits=2, active=active)
    np.testing.assert_array_equal(got[on].numpy(), full[on].numpy())
    assert not got[~on].any() and full[~on].any()
    rng = np.random.default_rng(4)
    ap = packing.pack(torch.from_numpy(rng.integers(0, 4, (E, M, K)).astype(np.uint8)), 2)
    lut = product_lut(quant.uniform_codebook(2), quant.uniform_codebook(2)).table
    gsc = torch.from_numpy(rng.uniform(0.01, 0.1, (E, N, K // 64)).astype(np.float32))
    for scales, G in ((None, None), (gsc, 64)):
        kw = dict(w_bits=2, a_bits=2, group_size=G)
        full = expert_lut_gemm_plain(ap, wp, lut, scales, **kw)
        got = expert_lut_gemm_plain(ap, wp, lut, scales, active=active, **kw)
        np.testing.assert_array_equal(got[on].numpy(), full[on].numpy())
        assert not got[~on].any() and full[~on].any()
        assert got.is_contiguous() and got.dtype == torch.float32
    everyone = torch.ones(E, dtype=flag_dtype)
    np.testing.assert_array_equal(
        expert_dequant_matmul_plain(x, wp, cb, sc, bits=2, active=everyone).numpy(),
        expert_dequant_matmul_plain(x, wp, cb, sc, bits=2).numpy())
