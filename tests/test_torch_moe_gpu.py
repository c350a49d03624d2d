"""The port's per-expert CUDA kernels (``expert_dequant_matmul``,
``expert_lut_gemm``) against their plain PyTorch versions on the card
(every test marked ``gpu``; each skips, from a fixture, without a card).
Run on the H100 with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_moe_gpu.py``. This file imports no jax.

Tolerances: expert_lut_gemm with an integer LUT is bit-identical per
channel (every partial sum is an exact integer in f32); with group scales
1e-5 relative to max|plain|, since the kernel scales each 8 units' partial
sum where the plain version scales each group's. The dequant kernel
rounds in the order its plain version replays (ref.py::tile_order_matmul
on expert_partition's tiling): bit-identical. With ``active`` given, the
flagged experts come out zero in both.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing, quant
from repro_torch.core.lut import product_lut
from repro_torch.kernels import build
from repro_torch.kernels.expert_gemm import (expert_dequant_matmul_cuda,
                                             expert_dequant_matmul_plain,
                                             expert_lut_gemm_cuda,
                                             expert_lut_gemm_plain)

RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dq_operands(seed, E, M, K, N, bits, group, dtype, dev, zero_expert=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, M, K)).astype(np.float32)
    if zero_expert:
        x[E // 2] = 0.0                   # a capacity slot nobody filled
    idx = rng.integers(0, 2 ** bits, size=(E, N, K)).astype(np.uint8)
    sc = rng.uniform(0.01, 0.1, size=(E, N) if group is None else (E, N, K // group))
    return (torch.from_numpy(x).to(dev, getattr(torch, dtype)),
            packing.pack(torch.from_numpy(idx), bits).to(dev),
            quant.uniform_codebook(bits, device=dev).levels,
            torch.from_numpy(sc.astype(np.float32)).to(dev))


def _lut_operands(seed, E, M, K, N, bits, group, dev, zero_expert=False):
    rng = np.random.default_rng(seed)
    a_idx = rng.integers(0, 2 ** bits, size=(E, M, K)).astype(np.uint8)
    if zero_expert:
        a_idx[E // 2] = 2 ** (bits - 1)   # code of 0.0: an unfilled slot
    w_idx = rng.integers(0, 2 ** bits, size=(E, N, K)).astype(np.uint8)
    sc = None if group is None else torch.from_numpy(
        rng.uniform(0.01, 0.1, size=(E, N, K // group)).astype(np.float32)).to(dev)
    lut = product_lut(quant.uniform_codebook(bits, device=dev),
                      quant.uniform_codebook(bits, device=dev)).table
    return (packing.pack(torch.from_numpy(a_idx), bits).to(dev),
            packing.pack(torch.from_numpy(w_idx), bits).to(dev), lut, sc)


# (E, M, K, N): moonshot-v1-16b-a3b's decode and prefill shapes, then edges:
# one expert, N off the column tile, K whose packed row is no whole number
# of 16-byte pieces or words (a partial last word, loaded byte by byte),
# rows off the row tile, one row.
_SHAPES = [(64, 4, 2048, 1408), (64, 4, 1408, 2048), (64, 16, 2048, 1408),
           (1, 4, 256, 96), (3, 5, 128, 100), (2, 3, 40, 17), (4, 1, 64, 8),
           (5, 9, 200, 33)]


def _zero_byte(bits):
    """The packed byte whose codes are all the code of 0.0 (an unfilled
    slot's quantized row)."""
    return sum(2 ** (bits - 1) << s for s in range(0, 8, bits))


def _active(seed, E, flagged, dev):
    """None, or a seeded (E,) bool flag with about half the experts off (the
    first always on); the flagged-off experts' rows are zeroed by the
    caller, as the dispatch leaves them."""
    if not flagged:
        return None
    on = np.random.default_rng(seed).random(E) < 0.5
    on[0] = True
    return torch.from_numpy(on).to(dev)


def _check_flagged(got, active):
    if active is not None:
        assert not got[~active].any()
        assert got[active].any()


@pytest.mark.gpu
@pytest.mark.parametrize("E,M,K,N", _SHAPES)
@pytest.mark.parametrize("bits,group", [(2, None), (2, 64), (4, None), (4, 8)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("flagged", [False, True])
def test_expert_dequant_matmul_kernel_matches_plain_on_card(cuda, E, M, K, N,
                                                            bits, group, dtype,
                                                            flagged):
    if group is not None and K % group:
        pytest.skip("K not a multiple of the group")
    ops = _dq_operands(E + M + K + N, E, M, K, N, bits, group, dtype, cuda,
                       zero_expert=E > 2)
    active = _active(E + K, E, flagged, cuda)
    if active is not None:
        ops[0][~active] = 0
    kw = dict(bits=bits, group_size=group, active=active)
    before = expert_dequant_matmul_cuda.launches
    got = expert_dequant_matmul_cuda(*ops, **kw)
    torch.cuda.synchronize()
    assert expert_dequant_matmul_cuda.launches == before + 1
    want = expert_dequant_matmul_plain(*ops, **kw)
    assert got.shape == want.shape == (E, M, N) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if E > 2:
        assert not got[E // 2].any()
    _check_flagged(got, active)


@pytest.mark.gpu
@pytest.mark.parametrize("E,M,K,N", _SHAPES)
@pytest.mark.parametrize("bits,group", [(2, None), (2, 64), (4, None), (4, 8)])
@pytest.mark.parametrize("flagged", [False, True])
def test_expert_lut_gemm_kernel_matches_plain_on_card(cuda, E, M, K, N, bits,
                                                      group, flagged):
    if group is not None and K % group:
        pytest.skip("K not a multiple of the group")
    ops = _lut_operands(E + M + K + N, E, M, K, N, bits, group, cuda,
                        zero_expert=E > 2)
    active = _active(E + K, E, flagged, cuda)
    if active is not None:
        ops[0][~active] = _zero_byte(bits)
    kw = dict(w_bits=bits, a_bits=bits, scheme="d", group_size=group, active=active)
    before = expert_lut_gemm_cuda.launches
    got = expert_lut_gemm_cuda(*ops, **kw)
    torch.cuda.synchronize()
    assert expert_lut_gemm_cuda.launches == before + 1
    want = expert_lut_gemm_plain(*ops, **kw)
    assert got.shape == want.shape == (E, M, N) and got.is_contiguous()
    if group is None:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL,
                                   atol=RTOL * want.abs().max().item())
    if E > 2:
        assert not got[E // 2].any()
    _check_flagged(got, active)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["expert_dequant_matmul", "expert_lut_gemm"])
def test_expert_kernels_every_tiling_matches_plain_on_card(cuda, op):
    """Every (NT, C) that expert_partition offers at a ragged shape (rows
    off the row tile, N off the column tile, K off the window), a flagged
    call included: one launch a call, the plain version's bits (the dequant
    replay on the same forced tiling)."""
    E, M, K, N = 3, 5, 1400, 100
    for cols in (64, 128):
        for ranks in range(1, 9):
            if op == "expert_dequant_matmul":
                ops = _dq_operands(ranks, E, M, K, N, 2, None, "bfloat16", cuda)
                kern, plain = expert_dequant_matmul_cuda, expert_dequant_matmul_plain
                kw = dict(bits=2)
                tile = dict(ranks=ranks, cols=cols)
            else:
                ops = _lut_operands(ranks, E, M, K, N, 2, None, cuda)
                kern, plain = expert_lut_gemm_cuda, expert_lut_gemm_plain
                kw = dict(w_bits=2, a_bits=2)
                tile = {}
            active = torch.tensor([True, ranks % 2 == 0, True], device=cuda)
            if not active[1]:
                ops[0][1] = 0 if op == "expert_dequant_matmul" else _zero_byte(2)
            before = kern.launches
            got = kern(*ops, **kw, active=active, ranks=ranks, cols=cols)
            torch.cuda.synchronize()
            assert kern.launches == before + 1
            want = plain(*ops, **kw, active=active, **tile)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            _check_flagged(got, active)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["expert_dequant_matmul", "expert_lut_gemm"])
@pytest.mark.parametrize("E,M,K,N", [(64, 4, 2048, 1408), (5, 9, 200, 33)])
def test_expert_kernels_skip_flagged_experts_with_live_rows_on_card(cuda, op, E, M,
                                                                    K, N):
    """A flagged-off expert keeps non-zero rows and weights: the kernel must
    skip it, not compute it. Its output is exactly zero (the unflagged call
    on the same operands gives non-zero there), and every active expert
    equals the plain version."""
    if op == "expert_dequant_matmul":
        ops = _dq_operands(E + K, E, M, K, N, 2, None, "bfloat16", cuda)
        kern, plain, kw = expert_dequant_matmul_cuda, expert_dequant_matmul_plain, dict(bits=2)
    else:
        ops = _lut_operands(E + K, E, M, K, N, 2, None, cuda)
        kern, plain, kw = expert_lut_gemm_cuda, expert_lut_gemm_plain, dict(w_bits=2, a_bits=2)
    active = _active(E + N, E, True, cuda)
    assert (~active).any()
    full = kern(*ops, **kw)
    before = kern.launches
    got = kern(*ops, **kw, active=active)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert (full[~active] != 0).any(dim=(1, 2)).all()
    assert not got[~active].any()
    torch.testing.assert_close(got, plain(*ops, **kw, active=active), rtol=0, atol=0)


@pytest.mark.gpu
def test_expert_kernels_reject_bad_operands_on_card(cuda):
    x, wp, cb, sc = _dq_operands(1, 2, 4, 64, 16, 2, None, "float32", cuda)
    with pytest.raises(TypeError):
        expert_dequant_matmul_cuda(x.half(), wp, cb, sc, bits=2)
    with pytest.raises(ValueError, match="contiguous"):
        expert_dequant_matmul_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                                   wp, cb, sc, bits=2)
    with pytest.raises(ValueError, match="do not fit"):
        expert_dequant_matmul_cuda(x[:1].contiguous(), wp, cb, sc, bits=2)
    with pytest.raises(ValueError, match="group_size"):
        expert_dequant_matmul_cuda(x, wp, cb, torch.ones((2, 16, 2), device=cuda),
                                   bits=2, group_size=48)
    with pytest.raises(ValueError, match="CUDA"):
        expert_dequant_matmul_cuda(x, wp.cpu(), cb, sc, bits=2)
    with pytest.raises(ValueError, match="active"):
        expert_dequant_matmul_cuda(x, wp, cb, sc, bits=2,
                                   active=torch.ones(3, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="active"):
        expert_dequant_matmul_cuda(x, wp, cb, sc, bits=2, active=torch.ones(2, device=cuda))
    with pytest.raises(NotImplementedError):
        expert_dequant_matmul_cuda(x, wp, cb, sc, bits=3)
    ap, wq, lut, _ = _lut_operands(2, 2, 4, 64, 16, 2, None, cuda)
    with pytest.raises(TypeError):
        expert_lut_gemm_cuda(ap.to(torch.int8), wq, lut, w_bits=2, a_bits=2)
    with pytest.raises(NotImplementedError, match="w_bits == a_bits"):
        expert_lut_gemm_cuda(ap, wq, lut, w_bits=2, a_bits=8)
    with pytest.raises(ValueError, match="LUT"):
        expert_lut_gemm_cuda(ap, wq, lut[:8].contiguous(), w_bits=2, a_bits=2)
    with pytest.raises(ValueError, match="go together"):
        expert_lut_gemm_cuda(ap, wq, lut, w_bits=2, a_bits=2, group_size=16)


@pytest.mark.gpu
def test_expert_kernel_launch_failure_raises_on_card(cuda):
    """65536 experts exceed the grid's z limit (65535 blocks): the launch
    is refused, and the wrapper raises instead of returning an unwritten
    output."""
    x, wp, cb, sc = _dq_operands(3, 65536, 1, 4, 1, 2, None, "float32", cuda)
    before = expert_dequant_matmul_cuda.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        expert_dequant_matmul_cuda(x, wp, cb, sc, bits=2)
    ap, wq, lut, _ = _lut_operands(4, 65536, 1, 4, 1, 2, None, cuda)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        expert_lut_gemm_cuda(ap, wq, lut, w_bits=2, a_bits=2)
    assert expert_dequant_matmul_cuda.launches == before
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_build_failure_raises_on_card(cuda, tmp_path, monkeypatch):
    """A source nvcc refuses makes the build raise with the compiler's
    output; nothing falls back."""
    (tmp_path / "broken.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="nvcc failed for broken.cu"):
        build.library("broken")
