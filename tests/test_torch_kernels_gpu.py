"""The port's CUDA kernels against their plain PyTorch versions on the card
(every test marked ``gpu``; each skips, from a fixture, without a card).
Run on the H100 with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_kernels_gpu.py``. This file imports no jax, so it also
runs where only PyTorch is installed.

Tolerances: lut_gemm with an integer LUT is bit-identical to the plain
version (exact integer partial sums in f32); with group scales 1e-5
relative. dequant_matmul sums its f32 FMAs in another order than
torch.matmul: 1e-4 relative and absolute.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing, quant
from repro_torch.core.lut import product_lut
from repro_torch.kernels.lut_dequant_matmul import (dequant_matmul_cuda,
                                                    dequant_matmul_plain)
from repro_torch.kernels.lut_gemm import lut_gemm_cuda, lut_gemm_plain

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


# --------------------------------------------------------------------------- #
# On the card (marked gpu; skipped without one)
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


_GPU_LUT = [(M, K, N, wb, ab, g) for M in (1, 4, 9, 32)
            for (K, N) in ((1024, 1024), (1024, 2816), (2816, 1024), (96, 40))
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
@pytest.mark.parametrize("M,K,N,bits,group,dtype",
                         [(M, K, N, b, g, dt) for M in (1, 4, 9, 32)
                          for (K, N) in ((1024, 1024), (1024, 2816), (2816, 1024))
                          for (b, g) in ((2, None), (2, 128), (4, None))
                          for dt in ("bfloat16", "float32")])
def test_dequant_matmul_kernel_matches_plain_on_card(cuda, M, K, N, bits, group,
                                                     dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    ta, wp, cb, sc = _dq_operands(M + K + N, M, K, N, bits, group, dtype)
    ops = [ta.to(cuda)] + [torch.from_numpy(x).to(cuda) for x in (wp, cb, sc)]
    got = dequant_matmul_cuda(*ops, bits=bits, group_size=group)
    torch.cuda.synchronize()
    want = dequant_matmul_plain(*ops, bits=bits, group_size=group)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


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
