"""The port's two-step bit-sliced kernel (``csrc/lut_gemm_bitsliced.cu``)
against its plain PyTorch version on the card (qwen's, the tp=2 slices' and
codeqwen's shapes, the edges, every cluster size, the widest packed sums,
small scale groups over a long K in several rounds), the fused kernel
beside it (every cluster size, the amax merge, several rounds), the
tiling's fit on the card, and a 2-rank tensor-parallel serve of the reduced qwen1.5-0.5b
on one card against the single-rank serve (every test marked ``gpu``; each
skips, from a fixture, without a card). Run on the H100 with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_tp_gpu.py``.
This file imports no jax.

Tolerances: per channel the kernel sums exact integers, so it must be
bit-identical to its plain version. With group scales it sums the groups'
scaled partials in ascending order with one rounding per product and per
sum, the order the plain version uses, merged over the cluster's ranks in
ascending group order: held to 1e-5 of max|plain| (the stated bound of the
grouped GEMMs), expected exact. The 2-rank serve under
w2a8_bs must give the single-rank serve's tokens and first-step logits bit
for bit (integer partials summed over the ranks are exact).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.kernels import lut_gemm_bitsliced as BS
from repro_torch.launch import mesh, serve
from repro_torch.models import lm

TOL_GROUPED = 1e-5
# (K, N): qwen1.5-0.5b's projections, and the K slices tp=2 serves
SHAPES = ((1024, 1024), (2816, 1024), (1024, 2816), (512, 1024), (1408, 1024))
# (label, M, K, N, bits, group)
EDGES = (("one group per row", 4, 1024, 256, 2, 1024),
         ("N off the warp tile", 4, 1024, 1003, 2, None),
         ("K off the chunk", 3, 1412, 64, 4, None),
         ("one pattern group per scale group", 5, 512, 40, 2, 4),
         ("group spans chunks", 32, 2048, 72, 4, 512),
         ("K of one pattern group", 1, 4, 16, 2, None),
         ("M 33, rows off the row tile", 33, 1024, 1024, 2, None),
         ("M 33, g64", 33, 2816, 1024, 4, 64),
         ("ragged last rank", 4, 1984, 1024, 2, 64),
         ("g4 over a long K, several rounds", 4, 13440, 4096, 2, 4))
# codeqwen1.5-7b's projections (K, N)
CODEQWEN_SHAPES = ((4096, 4096), (4096, 13440), (13440, 4096))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


def _operands(seed, M, K, N, bits, group, dev):
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    idx = torch.from_numpy(rng.integers(0, 2 ** bits, (N, K)).astype(np.uint8))
    planes = packing.pack_bitplanes_signed(idx, bits)
    sc = None if group is None else torch.from_numpy(
        (rng.random((N, K // group)) * 0.02 + 0.01).astype(np.float32))
    return [t if t is None else t.to(dev) for t in (codes, planes, sc)]


def _check(ops, bits, group, ranks=None):
    before = BS.lut_gemm_bitsliced_cuda.launches
    got = BS.lut_gemm_bitsliced_cuda(*ops, w_bits=bits, group_size=group, ranks=ranks)
    torch.cuda.synchronize()
    assert BS.lut_gemm_bitsliced_cuda.launches == before + 1
    want = BS.lut_gemm_bitsliced_plain(*ops, w_bits=bits, group_size=group)
    assert torch.isfinite(got).all()
    if group is None:
        assert torch.equal(got, want), (got - want).abs().max().item()
    else:
        err = (got - want).abs().max().item()
        assert err <= TOL_GROUPED * want.abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("group", [None, 64])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("K,N", SHAPES)
def test_two_step_kernel_matches_plain_at_serve_shapes(cuda, K, N, M, bits, group):
    _check(_operands(K + N + M + bits, M, K, N, bits, group, cuda), bits, group)


@pytest.mark.gpu
@pytest.mark.parametrize("label,M,K,N,bits,group", EDGES, ids=[e[0] for e in EDGES])
def test_two_step_kernel_matches_plain_at_the_edges(cuda, label, M, K, N, bits, group):
    _check(_operands(len(label), M, K, N, bits, group, cuda), bits, group)


@pytest.mark.gpu
@pytest.mark.parametrize("group", [None, 64])
@pytest.mark.parametrize("K,N", CODEQWEN_SHAPES)
def test_two_step_kernel_matches_plain_at_codeqwen_shapes(cuda, K, N, group):
    _check(_operands(K + N, 4, K, N, 2, group, cuda), 2, group)


@pytest.mark.gpu
@pytest.mark.parametrize("group", [None, 64])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
@pytest.mark.parametrize("M", [1, 4, 13])
def test_two_step_kernel_matches_plain_at_each_cluster_size(cuda, M, C, bits, group):
    """K = 1984 (31 segments): C = 2, 3 and 8 leave a ragged last rank."""
    K, N = 1984, 200
    assert BS.bs_partition(M, N, K, group, ranks=C)[2] == C
    _check(_operands(M * C + bits, M, K, N, bits, group, cuda), bits, group, C)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("code", [-128, 127])
def test_two_step_kernel_exact_at_the_widest_packed_sums(cuda, bits, code):
    """Every code at an extreme against every plane pattern 0xF: the packed
    16-bit lanes at their fullest (w4's high plane coefficient -8)."""
    M, K, N = 4, 1024, 1024
    codes = torch.full((M, K), code, dtype=torch.int8, device=cuda)
    idx = torch.full((N, K), 2 ** (bits - 1) - 1, dtype=torch.uint8, device=cuda)
    planes = packing.pack_bitplanes_signed(idx, bits)
    got = BS.lut_gemm_bitsliced_cuda(codes, planes, w_bits=bits)
    assert bool((got == -float(code * K)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("group", [None, 64])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
@pytest.mark.parametrize("M", [1, 4, 13])
def test_fused_kernel_matches_plain_at_each_cluster_size(cuda, M, C, group):
    """The cluster's amax merge: an all-zero row and a row whose amax sits
    in the last rank's slice; per channel bit-identical, grouped within the
    stated tolerance."""
    _check_fused(cuda, M, 1984, 200, group, C)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 13])
def test_fused_kernel_matches_plain_in_several_rounds(cuda, M):
    """Codeqwen's w_down (K 13440) in groups of 4: the partials of one
    round would not fit, so the ranks walk K in rounds; the amax reaches
    every window."""
    assert BS.bs_rounds(13440, *BS.bs_partition(M, 4096, 13440, 4)[2:]) > 1
    _check_fused(cuda, M, 13440, 4096, 4, None)


def _check_fused(cuda, M, K, N, group, C):
    rng = np.random.default_rng(M + (C or 0))
    x = rng.standard_normal((M, K)).astype(np.float32)
    if M > 2:
        x[0] = 0.0
        x[1] *= 1e-3
        x[1, K - 3] = 40.0
    x = torch.from_numpy(x).to(cuda, torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 4, (N, K)).astype(np.uint8))
    planes = packing.pack_bitplanes_signed(idx, 2).to(cuda)
    sc = torch.from_numpy((rng.random((N,) if group is None else (N, K // group))
                           * 0.02 + 0.01).astype(np.float32)).to(cuda)
    got = BS.lut_gemm_bs_fused_cuda(x, planes, sc, w_bits=2, group_size=group, ranks=C)
    torch.cuda.synchronize()
    want = BS.lut_gemm_bs_fused_plain(x, planes, sc, w_bits=2, group_size=group)
    err = (got - want).abs().max().item()
    assert err <= (0.0 if group is None else TOL_GROUPED * want.abs().max().item()), err


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["lut_gemm_bs_fused", "lut_gemm_bitsliced"])
@pytest.mark.parametrize("M,K,N", [(4, 1024, 2816), (4, 1024, 1024), (32, 2816, 1024),
                                   (4, 4096, 13440), (4, 13440, 4096)])
@pytest.mark.parametrize("group", [None, 4])
def test_bs_tiling_fits_the_card(cuda, op, M, K, N, group):
    """Every cluster of bs_partition's tiling fits the card (a cluster that
    does not fit on one GPC never launches)."""
    (_, _, C, _), active = BS.bs_active_clusters(op, M, N, K, 2, group)
    assert active >= 1 and C <= BS.BS_MAX_CLUSTER


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("M", [1, 4, 32])
def test_refactored_fused_kernel_still_bit_identical_per_channel(cuda, M, bits):
    rng = np.random.default_rng(M + bits)
    K, N = 2816, 1024
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 2 ** bits, (N, K)).astype(np.uint8))
    planes = packing.pack_bitplanes_signed(idx, bits).to(cuda)
    sc = torch.from_numpy((rng.random(N) * 0.02 + 0.01).astype(np.float32)).to(cuda)
    got = BS.lut_gemm_bs_fused_cuda(x, planes, sc, w_bits=bits)
    torch.cuda.synchronize()
    want = BS.lut_gemm_bs_fused_plain(x, planes, sc, w_bits=bits)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.gpu
def test_two_ranks_on_one_card_serve_like_one(cuda):
    """``--tp 2`` on one card (2 gloo ranks on cuda:0) against the
    single-rank serve of the reduced qwen1.5-0.5b under w2a8_bs: the same
    tokens and first-step logits, every rank alike, every row projection
    through the two-step kernel and every first-step call of it equal to
    its plain version."""
    args = serve.build_parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--paged", "--device", "cuda",
         "--plan", "w2a8_bs", "--requests", "4", "--gen", "6"])
    res = mesh.run_ranks(serve.serve_rank, 2, args, ("lut_gemm_bitsliced",),
                         device="cuda")
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
    np.testing.assert_array_equal(res["first_logits"], cap["logits"].cpu().numpy())
    forwards = res["decode_steps"] + res["prefill_chunks"]
    whole = {p: qw.packed.numel() for p, qw in lm.qweights(qparams).items()}
    for r in res["ranks"]:
        assert r["launches"]["lut_gemm_bitsliced"] == 2 * cfg.n_layers * forwards
        assert r["launches"]["lut_gemm_bs_fused"] == 5 * cfg.n_layers * forwards
        assert r["first_step_calls"]["lut_gemm_bitsliced"] == 2 * cfg.n_layers
        assert r["first_step_errs"]["lut_gemm_bitsliced"] == 0.0
        assert all(2 * b == whole[p] for p, b in r["role_packed_bytes"].items())
