"""The conv stack on the card (core/conv.py, models/cnn.py): im2col gives
the CPU's bits, and the CNN's im2col ``lut_gemm`` calls (M up to 8192, K
from 28) against their plain versions, one conv at the full CNN's shapes
and the reduced stack end to end (every test marked ``gpu``; each skips,
from a fixture, without a card). Run on the H100 with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_conv_gpu.py``.
This file imports no jax.

Tolerance: none. Per channel the plain ``lut_gemm`` replays the kernel's
walk, so a k-means (float) table agrees bit for bit too, and the rest of
the stack runs the same operations.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import conv
from repro_torch.core.qlinear import QuantPolicy
from repro_torch.kernels import lut_gemm as LG, registry
from repro_torch.models import cnn

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"), (2, "VALID")])
def test_im2col_on_card_is_the_cpus(cuda, stride, padding):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 9, 7, 5))
                         .astype(np.float32))
    want, shape = conv.im2col(x, 3, 3, stride, padding)
    got, shape_c = conv.im2col(x.to(cuda), 3, 3, stride, padding)
    assert shape == shape_c and torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("w_bits,a_bits,kmeans", [(2, 2, False), (4, 4, False),
                                                  (2, 2, True)])
def test_stem_and_widest_conv_at_full_shapes(cuda, w_bits, a_bits, kmeans):
    """The stem (K 27 -> 28, N 64) and the last conv (K 4608, N 512) at M
    8192 (batch 8 of 32x32): every lut_gemm call against its plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    pol = QuantPolicy(w_bits=w_bits, a_bits=a_bits, nonuniform=kmeans)
    for cin, cout in ((3, 64), (512, 512)):
        p = conv.conv2d_init(gen, 3, 3, cin, cout, device=cuda)
        qw = cnn.quantize([p], pol)[0]
        x = torch.relu(torch.randn((8, 32, 32, cin), generator=gen, device=cuda))
        errs = []
        with registry.checked_against_plain(("lut_gemm",), errs):
            y = conv.conv2d_serve(qw, x, 3, 3, a_bits=a_bits)
        assert y.shape == (8, 32, 32, cout) and len(errs) == 1
        assert errs[0] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("w_bits,a_bits,kmeans", [(2, 2, False), (4, 4, False),
                                                  (2, 2, True)])
def test_reduced_stack_kernel_equals_plain(cuda, w_bits, a_bits, kmeans):
    cfg = cnn.reduce_for_smoke(get_config("deepgemm-cnn"))
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = cnn.init_params(cfg, gen, cuda)
    qws = cnn.quantize(params, QuantPolicy(w_bits=w_bits, a_bits=a_bits, nonuniform=kmeans))
    x = torch.randn((2, cfg.img_hw, cfg.img_hw, cfg.in_ch), generator=gen, device=cuda)
    before = LG.lut_gemm_cuda.launches
    y = cnn.forward_lut(qws, x, a_bits=a_bits)
    assert LG.lut_gemm_cuda.launches - before == len(params)
    assert torch.equal(y, cnn.forward_lut(qws, x, a_bits=a_bits, backend="ref"))
