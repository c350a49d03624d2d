"""The quantization front end on the card: rows 1-2 on k-means leaves (a
float product table in ``lut_gemm``, a float codebook in
``dequant_matmul``, whose separately rounded branch of
``csrc/dense_dequant.cuh`` the tied replay must give bit for bit), the
codebook fit on the card against the CPU's, and the reduced qwen1.5-0.5b
through the paged engine under ``--nonuniform``, ``--a-scale static`` and
``--plan legacy`` (every test marked ``gpu``; each skips, from a fixture,
without a card). Run on the H100 with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_quant_front_gpu.py``.
This file imports no jax.

Tolerances: none for the kernels (``dequant_matmul`` is tied to
``ref.py::tile_order_matmul``, ``lut_gemm`` per channel to
``ref.py::tile_order_lut_gemm``, which sums a float table in the walk's
order) and the engine's tokens; the k-means levels on the card within
1e-6 relative of the CPU's (float64 cluster sums in another reduction
order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import packing, qplan, quant
from repro_torch.core.qlinear import QuantPolicy, quantize_weight
from repro_torch.kernels import lut_dequant_matmul as LD, lut_gemm as LG
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving import Engine, Request

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


def _leaf(dev, a_bits, K=1024, N=320, seed=0):
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal((K, N))
                         .astype(np.float32)).to(dev)
    return quantize_weight(w, QuantPolicy(w_bits=2, a_bits=a_bits, nonuniform=True,
                                          kernel="auto"))


@pytest.mark.gpu
def test_kmeans_fit_on_card_matches_cpu(cuda):
    x = np.random.default_rng(1).standard_normal((512, 700)).astype(np.float32)
    for bits in (2, 4):
        want = quant.kmeans_codebook(torch.from_numpy(x), bits).levels
        got = quant.kmeans_codebook(torch.from_numpy(x).to(cuda), bits).levels.cpu()
        assert torch.allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 33, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequant_matmul_float_codebook_is_tied(cuda, M, dtype):
    qw = _leaf(cuda, None)
    assert not bool((qw.codebook == qw.codebook.round()).all())
    x = torch.randn((M, qw.k_padded), generator=torch.Generator(device=cuda)
                    .manual_seed(M), device=cuda).to(dtype)
    before = LD.dequant_matmul_cuda.launches
    got = LD.dequant_matmul_cuda(x, qw.packed, qw.codebook, qw.scales, bits=2)
    torch.cuda.synchronize()
    assert LD.dequant_matmul_cuda.launches == before + 1
    want = LD.dequant_matmul_plain(x, qw.packed, qw.codebook, qw.scales, bits=2)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 4, 33, 128])
def test_lut_gemm_float_table(cuda, M):
    qw = _leaf(cuda, 2)
    gen = torch.Generator(device=cuda).manual_seed(M)
    a = torch.randint(0, 4, (M, qw.k_padded), generator=gen, device=cuda,
                      dtype=torch.uint8)
    ap = packing.pack(a, 2)
    got = LG.lut_gemm_cuda(ap, qw.packed, qw.plut, None, w_bits=2, a_bits=2)
    torch.cuda.synchronize()
    want = LG.lut_gemm_plain(ap, qw.packed, qw.plut, None, w_bits=2, a_bits=2,
                             float_table=qw.nonuniform)
    assert torch.equal(got, want)


def _serve(cfg, params, **kw):
    rng = np.random.default_rng(0)
    eng = Engine(cfg, params, n_slots=4, max_len=64, block_size=16, **kw)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n), max_new=8)
            for i, n in enumerate((4, 9, 17, 30, 5, 12))]
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    return [r.out for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize("flags,op", [
    (["--nonuniform"], LD.dequant_matmul_cuda),
    (["--plan", "w2a2", "--nonuniform"], LG.lut_gemm_cuda),
    (["--plan", "w2a2", "--a-scale", "static", "--calib-batches", "2"], LG.lut_gemm_cuda),
    (["--plan", "legacy"], None)])
def test_engine_under_the_front_end_flags(cuda, flags, op):
    """The CLI's plan and packing (calibration included) on the card: the
    planned GEMM kernel carries every projection and gives its plain-GEMM
    run's tokens; legacy leaves launch no GEMM kernel."""
    args = serve.build_parser().parse_args(["--arch", "qwen1.5-0.5b", "--smoke",
                                            "--paged", *flags])
    cfg, desc = serve.config_for(args)
    cfg = dataclasses.replace(cfg, n_layers=2, kv_cache_dtype="int8")
    params = serve.pack_params(cfg, args, desc, calibrate=args.a_scale == "static")
    gemms = (LG.lut_gemm_cuda, LD.dequant_matmul_cuda)
    before = [g.launches for g in gemms]
    toks = _serve(cfg, params)
    launched = [g.launches - b for g, b in zip(gemms, before)]
    if op is None:
        assert launched == [0, 0] and all(len(t) == 8 for t in toks)
        return
    assert launched[gemms.index(op)] > 0 and sum(launched) == launched[gemms.index(op)]
    if "static" in flags:
        assert all(qw.a_sc is not None for qw in lm.qweights(params).values())
    plain = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend="ref"))
    assert _serve(plain, params) == toks
