"""The port's CUDA kernels against their plain PyTorch versions on the card
(every test marked ``gpu``; each skips, from a fixture, without a card).
Run on the H100 with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_kernels_gpu.py``. This file imports no jax, so it also
runs where only PyTorch is installed.

Tolerances: lut_gemm with an integer LUT is bit-identical to the plain
version (exact integer partial sums in f32); with group scales 1e-5
relative. dequant_matmul rounds in the order its plain version repeats
(ref.py::tile_order_matmul, on the same dense_partition tiling):
bit-identical. lut_gemm_bs_fused quantizes the
rows with the plain version's arithmetic and sums exact integers, so per
channel it is bit-identical; with group scales 1e-5 relative to the
largest output (the stated bound; its cluster merge sums the groups in the
plain version's ascending order, so it is expected exact).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing, quant
from repro_torch.core.lut import product_lut
from repro_torch.kernels.lut_dequant_matmul import (dequant_matmul_cuda,
                                                    dequant_matmul_plain)
from repro_torch.kernels.lut_gemm import lut_gemm_cuda, lut_gemm_plain
from repro_torch.kernels.lut_gemm_bitsliced import (lut_gemm_bs_fused_cuda,
                                                    lut_gemm_bs_fused_plain)

RTOL = 1e-5


def _lut_operands(seed, M, K, N, w_bits, a_bits, group=None):
    rng = np.random.default_rng(seed)
    a_idx = rng.integers(0, 2 ** a_bits, size=(M, K)).astype(np.uint8)
    w_idx = rng.integers(0, 2 ** w_bits, size=(N, K)).astype(np.uint8)
    lut = product_lut(quant.uniform_codebook(w_bits),
                      quant.uniform_codebook(a_bits)).table.numpy()
    sc = None
    if group is not None:
        sc = rng.uniform(0.01, 0.1, size=(N, K // group)).astype(np.float32)
    ap = packing.pack(torch.from_numpy(a_idx), a_bits).numpy()
    wp = packing.pack(torch.from_numpy(w_idx), w_bits).numpy()
    return ap, wp, lut, sc


def _dq_operands(seed, M, K, N, bits, group, dtype):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    w_idx = rng.integers(0, 2 ** bits, size=(N, K)).astype(np.uint8)
    cb = quant.uniform_codebook(bits).levels.numpy()
    sc = rng.uniform(0.01, 0.1, size=(N,) if group is None else (N, K // group))
    wp = packing.pack(torch.from_numpy(w_idx), bits).numpy()
    return a.to(getattr(torch, dtype)), wp, cb, sc.astype(np.float32)


def _bs_operands(seed, M, K, N, bits, group, dtype, a_sc):
    """x with an all-zero row and a row whose amax sits in one element,
    bit planes, scales and the optional static (1, 1) / per-row (M, 1)
    activation scale."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    if M > 1:
        x[0] = 0.0
    if M > 2:
        x[1] *= 1e-3
        x[1, K // 3] = 40.0
    idx = rng.integers(0, 2 ** bits, size=(N, K)).astype(np.uint8)
    sc = rng.uniform(0.01, 0.03, size=(N,) if group is None else (N, K // group))
    asc = {None: None, "static": np.array([[0.037]]),
           "rows": rng.uniform(0.01, 0.05, size=(M, 1))}[a_sc]
    planes = packing.pack_bitplanes_signed(torch.from_numpy(idx), bits)
    return (torch.from_numpy(x).to(getattr(torch, dtype)), planes,
            torch.from_numpy(sc.astype(np.float32)),
            None if asc is None else torch.from_numpy(asc.astype(np.float32)))


# --------------------------------------------------------------------------- #
# On the card (marked gpu; skipped without one)
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


# (K, N): qwen1.5-0.5b's projections, the K slices tp=2 gives the row-
# parallel leaves (512 x 1024, 1408 x 1024), N and K off the tiles, a tiny
# shape; M up to the fixed loop's prefill (128)
_GPU_DENSE_SHAPES = ((1024, 1024), (1024, 2816), (2816, 1024), (512, 1024),
                     (1408, 1024), (1412, 1003), (96, 40))
_GPU_LUT = [(M, K, N, wb, ab, g) for M in (1, 4, 9, 32, 128)
            for (K, N) in _GPU_DENSE_SHAPES
            for (wb, ab, g) in ((2, 2, None), (2, 2, 64), (4, 8, None),
                                (2, 8, None), (4, 4, None))]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,wb,ab,group", _GPU_LUT)
def test_lut_gemm_kernel_matches_plain_on_card(cuda, M, K, N, wb, ab, group):
    if group is not None and K % group:
        pytest.skip("K not a multiple of the group")
    ops = [None if x is None else torch.from_numpy(x).to(cuda)
           for x in _lut_operands(M + K + N, M, K, N, wb, ab, group)]
    before = lut_gemm_cuda.launches
    got = lut_gemm_cuda(*ops, w_bits=wb, a_bits=ab, group_size=group)
    torch.cuda.synchronize()
    assert lut_gemm_cuda.launches == before + 1
    want = lut_gemm_plain(*ops, w_bits=wb, a_bits=ab, group_size=group)
    if group is None:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.gpu
def test_lut_gemm_first_launch_counts_its_static_table_on_card(cuda):
    """In a fresh process (no earlier launch has raised the kernel's shared-
    memory limit), w4a8 at M 32, 1024 x 1024 launches first: its block
    takes under 48 KB of dynamic shared memory but above 48 KB with its
    16 KB static table, so the launch must raise the limit itself."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = (
        "import torch\n"
        "from test_torch_kernels_gpu import _lut_operands\n"
        "from repro_torch.kernels.lut_gemm import lut_gemm_cuda, lut_gemm_plain\n"
        "ops = [None if x is None else torch.from_numpy(x).cuda()\n"
        "       for x in _lut_operands(7, 32, 1024, 1024, 4, 8)]\n"
        "got = lut_gemm_cuda(*ops, w_bits=4, a_bits=8)\n"
        "want = lut_gemm_plain(*ops, w_bits=4, a_bits=8)\n"
        "torch.testing.assert_close(got, want, rtol=0, atol=0)\n")
    here = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": f"{here.parent / 'src'}:{here}"}
    run = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,bits,group,dtype",
                         [(M, K, N, b, g, dt) for M in (1, 4, 9, 32, 128)
                          for (K, N) in _GPU_DENSE_SHAPES
                          for (b, g) in ((2, None), (2, 128), (4, None))
                          for dt in ("bfloat16", "float32")])
def test_dequant_matmul_kernel_matches_plain_on_card(cuda, M, K, N, bits, group,
                                                     dtype):
    if group is not None and K % group:
        pytest.skip("K not a multiple of the group")
    torch.backends.cuda.matmul.allow_tf32 = False
    ta, wp, cb, sc = _dq_operands(M + K + N, M, K, N, bits, group, dtype)
    ops = [ta.to(cuda)] + [torch.from_numpy(x).to(cuda) for x in (wp, cb, sc)]
    before = dequant_matmul_cuda.launches
    got = dequant_matmul_cuda(*ops, bits=bits, group_size=group)
    torch.cuda.synchronize()
    assert dequant_matmul_cuda.launches == before + 1
    want = dequant_matmul_plain(*ops, bits=bits, group_size=group)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 1024, 2816), (32, 2816, 1024), (128, 1024, 1024)])
def test_dense_kernels_match_plain_at_every_tiling_on_card(cuda, M, K, N):
    """Every (NT, C) dense_partition takes: dequant_matmul bit-identical to
    its plain version on the same tiling (bf16 and f32 rows, w2 per channel
    and g128), lut_gemm w2a2 bit-identical."""
    from repro_torch.kernels.lut_gemm import DENSE_COL_TILES, DENSE_MAX_CLUSTER
    for dt in ("bfloat16", "float32"):
        for g in (None, 128):
            ta, wp, cb, sc = _dq_operands(M + K, M, K, N, 2, g, dt)
            dq = [ta.to(cuda)] + [torch.from_numpy(x).to(cuda) for x in (wp, cb, sc)]
            for NT in DENSE_COL_TILES:
                for C in range(1, DENSE_MAX_CLUSTER + 1):
                    kw = dict(bits=2, group_size=g, ranks=C, cols=NT)
                    got = dequant_matmul_cuda(*dq, **kw)
                    torch.testing.assert_close(got, dequant_matmul_plain(*dq, **kw),
                                               rtol=0, atol=0)
    lut_ops = [torch.from_numpy(x).to(cuda)
               for x in _lut_operands(M, M, K, N, 2, 2)[:3]]
    want = lut_gemm_plain(*lut_ops, w_bits=2, a_bits=2)
    for NT in DENSE_COL_TILES:
        for C in range(1, DENSE_MAX_CLUSTER + 1):
            got = lut_gemm_cuda(*lut_ops, w_bits=2, a_bits=2, ranks=C, cols=NT)
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_operands_on_card(cuda):
    ops = [torch.from_numpy(x).to(cuda)
           for x in _lut_operands(1, 4, 64, 16, 2, 2)[:3]]
    with pytest.raises(TypeError):
        lut_gemm_cuda(ops[0].to(torch.int8), *ops[1:], w_bits=2, a_bits=2)
    with pytest.raises(ValueError, match="contiguous"):
        lut_gemm_cuda(ops[0].t().contiguous().t(), *ops[1:], w_bits=2, a_bits=2)
    with pytest.raises(NotImplementedError):
        lut_gemm_cuda(*ops, w_bits=3, a_bits=3)


_GPU_BS = [(M, K, N, b, g, a, dt) for M in (1, 4, 9, 32)
           for (K, N) in ((1024, 1024), (1024, 2816), (2816, 1024), (96, 40))
           for (b, g, a) in ((2, None, None), (4, None, None), (2, 64, None),
                             (2, None, "static"), (4, 32, "rows"))
           for dt in ("bfloat16", "float32")
           if g is None or K % g == 0]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,bits,group,a_sc,dtype", _GPU_BS)
def test_lut_gemm_bs_fused_kernel_matches_plain_on_card(cuda, M, K, N, bits, group,
                                                         a_sc, dtype):
    ops = [None if t is None else t.to(cuda)
           for t in _bs_operands(M + K + N, M, K, N, bits, group, dtype, a_sc)]
    before = lut_gemm_bs_fused_cuda.launches
    got = lut_gemm_bs_fused_cuda(*ops, w_bits=bits, a_bits=8, group_size=group)
    torch.cuda.synchronize()
    assert lut_gemm_bs_fused_cuda.launches == before + 1
    want = lut_gemm_bs_fused_plain(*ops, w_bits=bits, a_bits=8, group_size=group)
    if group is None:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL,
                                   atol=RTOL * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,bits,a_bits,group,dtype",
                         [(M, K, N, b, ab, g, dt) for M in (1, 4, 32)
                          for (K, N) in ((1024, 2816), (96, 40))
                          for (b, ab, g) in ((2, 2, None), (4, 4, None), (2, 4, 32))
                          for dt in ("bfloat16", "float32")])
def test_lut_gemm_bs_fused_kernel_matches_plain_at_narrow_a_bits_on_card(
        cuda, M, K, N, bits, a_bits, group, dtype):
    """a_bits below 8 change the kernel's clamp bounds and scale divisor."""
    ops = [None if t is None else t.to(cuda)
           for t in _bs_operands(M + K + a_bits, M, K, N, bits, group, dtype, None)]
    got = lut_gemm_bs_fused_cuda(*ops, w_bits=bits, a_bits=a_bits, group_size=group)
    want = lut_gemm_bs_fused_plain(*ops, w_bits=bits, a_bits=a_bits, group_size=group)
    if group is None:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL,
                                   atol=RTOL * want.abs().max().item())


@pytest.mark.gpu
def test_lut_gemm_bs_fused_rejects_bad_operands_on_card(cuda):
    x, planes, sc, _ = [None if t is None else t.to(cuda)
                        for t in _bs_operands(2, 4, 64, 16, 2, None, "float32", None)]
    kw = dict(w_bits=2, a_bits=8)
    with pytest.raises(TypeError):
        lut_gemm_bs_fused_cuda(x.to(torch.float16), planes, sc, **kw)
    with pytest.raises(TypeError):
        lut_gemm_bs_fused_cuda(x, planes.to(torch.int8), sc, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        lut_gemm_bs_fused_cuda(x, planes.transpose(1, 2).contiguous().transpose(1, 2),
                               sc, **kw)
    with pytest.raises(ValueError, match="multiple of 4"):
        lut_gemm_bs_fused_cuda(x[:, :62].contiguous(), planes, sc, **kw)
    gs = torch.ones((16, 2), device=cuda)
    with pytest.raises(ValueError, match="group_size"):
        lut_gemm_bs_fused_cuda(x, planes, gs, w_bits=2, a_bits=8, group_size=48)
    with pytest.raises(ValueError, match="a_sc"):
        lut_gemm_bs_fused_cuda(x, planes, sc, torch.ones((2, 1), device=cuda), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        lut_gemm_bs_fused_cuda(x, planes.cpu(), sc, **kw)
    with pytest.raises(NotImplementedError):
        lut_gemm_bs_fused_cuda(x, planes, sc, w_bits=3, a_bits=8)
