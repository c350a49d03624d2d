"""The port's conv stack (core/conv.py, models/cnn.py, the deepgemm-cnn
config) against the JAX reference on the CPU: im2col, the plain conv, the
packed LUT conv under w2a2, w4a4 and k-means w2a2, and the reduced CNN
(widths 8-16, 8x8 images, batch 2) through both paths; then the example
script on the CPU.

Inputs come from numpy with a seed; the reference's conv params and
packed leaves are carried across with the bridge. Tolerances:
- im2col: bit for bit (the same gathers, SAME padded ph // 2 before).
- plain conv: within 1e-5 of max|ref| (f32 products summed in another
  order).
- uniform LUT conv: bit for bit. The reference's 'ref' backend sums the
  same integer products in a dequant dot, the port's plain ``lut_gemm`` in
  its gather order; integer sums in f32 are exact in any order, and the
  activation quantization and scale epilogue are the same f32 operations.
- k-means LUT conv: within 1e-5 of max|ref| (a float product table).
- reduced stack: the last layer's LUT activation maps bit for bit on
  uniform plans (the global mean then sums in another order), the plain
  features within 1e-5 of max|ref|.
"""

import dataclasses
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import conv as jconv, qlinear as jqlinear
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import conv, qlinear
from repro_torch.models import cnn

KEY = jax.random.PRNGKey(0)
PLAIN_REL = 1e-5
KMEANS_REL = 1e-5


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kh,kw,stride,padding", [
    (3, 3, 1, "SAME"), (3, 3, 2, "SAME"), (2, 4, 1, "SAME"), (2, 2, 2, "SAME"),
    (3, 3, 1, "VALID"), (3, 2, 2, "VALID")])
def test_im2col_matches_reference_bit_for_bit(kh, kw, stride, padding):
    x = _x(0, (2, 7, 5, 3))
    want, wshape = jconv.im2col(jnp.asarray(x), kh, kw, stride, padding)
    got, shape = conv.im2col(torch.from_numpy(x), kh, kw, stride, padding)
    assert shape == tuple(wshape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if padding == "SAME":
        assert conv.conv_gemm_shape(x.shape, kh, kw, 6, stride) == \
            jconv.conv_gemm_shape(x.shape, kh, kw, 6, stride)


def _conv_pair(cin=5, cout=12):
    jp = jconv.conv2d_init(KEY, 3, 3, cin, cout)
    tp = bridge.conv_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def test_conv2d_apply_matches_reference():
    jp, tp = _conv_pair()
    assert {k: tp[k] for k in ("kh", "kw", "cin", "cout")} == {
        "kh": 3, "kw": 3, "cin": 5, "cout": 12}
    x = _x(1, (2, 7, 5, 5))
    want = np.asarray(jconv.conv2d_apply(jp, jnp.asarray(x)))
    got = conv.conv2d_apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 7, 5, 12)
    assert np.abs(got - want).max() <= PLAIN_REL * np.abs(want).max()
    mine = conv.conv2d_init(torch.Generator().manual_seed(0), 3, 3, 5, 12)
    assert mine["w"].shape == (45, 12) and mine["w"].dtype == torch.float32
    dense = qlinear.dense_init(torch.Generator().manual_seed(0), 5, 7, bias=True)
    y = qlinear.dense_apply(dense, torch.from_numpy(x))
    assert y.shape == (2, 7, 5, 7)
    np.testing.assert_array_equal(y.numpy(), (torch.from_numpy(x) @ dense["w"]).numpy())


@pytest.mark.parametrize("w_bits,a_bits,nonuniform", [(2, 2, False), (4, 4, False),
                                                      (2, 2, True)])
def test_conv2d_serve_matches_reference(w_bits, a_bits, nonuniform):
    jp, tp = _conv_pair()
    pol = dict(w_bits=w_bits, a_bits=a_bits, nonuniform=nonuniform)
    jq = jqlinear.quantize_weight(jp["w"], jqlinear.QuantPolicy(**pol))
    carried = bridge.qweight_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    mine = qlinear.quantize_weight(tp["w"], qlinear.QuantPolicy(**pol))
    assert carried.nonuniform == mine.nonuniform == nonuniform
    x = _x(2, (2, 7, 5, 5))
    want = np.asarray(jconv.conv2d_serve(jq, jnp.asarray(x), 3, 3, a_bits=a_bits,
                                         backend="ref"))
    got = conv.conv2d_serve(carried, torch.from_numpy(x), 3, 3, a_bits=a_bits,
                            backend="ref").numpy()
    assert got.shape == want.shape == (2, 7, 5, 12)
    if nonuniform:
        assert np.abs(got - want).max() <= KMEANS_REL * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)
        for f in ("packed", "codebook", "scales"):
            np.testing.assert_array_equal(getattr(mine, f).numpy(), np.asarray(getattr(jq, f)))


def test_cnn_config_matches_reference():
    mine, ref = get_config("deepgemm-cnn"), jget_config("deepgemm-cnn")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert cnn.channels(mine) == [64, 64, 64, 128, 128, 256, 256, 512, 512]


@pytest.mark.parametrize("w_bits,a_bits", [(2, 2), (4, 4)])
def test_reduced_stack_matches_reference(w_bits, a_bits):
    """The reference example's stack at CPU size (its two forwards under
    jit, as the example runs them) against the port's on the reference's
    weights."""
    cfg = cnn.reduce_for_smoke(get_config("deepgemm-cnn"))
    jps, cin = [], cfg.in_ch
    for i, cout in enumerate(cnn.channels(cfg)):
        jps.append(jconv.conv2d_init(jax.random.fold_in(KEY, i), 3, 3, cin, cout))
        cin = cout
    tps = [bridge.conv_params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
           for p in jps]
    pol = dict(w_bits=w_bits, a_bits=a_bits)
    jqs = [jqlinear.quantize_weight(p["w"], jqlinear.QuantPolicy(**pol)) for p in jps]
    tqs = cnn.quantize(tps, qlinear.QuantPolicy(**pol))
    x = _x(3, (2, cfg.img_hw, cfg.img_hw, cfg.in_ch))

    @jax.jit
    def ref_stacks(x):                  # the reference example's two forwards
        jx, jy = x, x
        for p, qw in zip(jps, jqs):
            jx = jax.nn.relu(jconv.conv2d_apply(p, jx))
            jy = jax.nn.relu(jconv.conv2d_serve(qw, jy, 3, 3, a_bits=a_bits,
                                                backend="ref"))
        return jx.mean((1, 2)), jy

    want_fp, want_maps = (np.asarray(a) for a in ref_stacks(jnp.asarray(x)))
    maps = torch.from_numpy(x)
    for qw in tqs:                      # cnn.forward_lut's layers
        maps = torch.relu(conv.conv2d_serve(qw, maps, 3, 3, a_bits=a_bits, backend="ref"))
    np.testing.assert_array_equal(maps.numpy(), want_maps)
    got_q = cnn.forward_lut(tqs, torch.from_numpy(x), a_bits=a_bits, backend="ref")
    np.testing.assert_array_equal(got_q.numpy(), maps.mean((1, 2)).numpy())
    got_fp = cnn.forward_plain(tps, torch.from_numpy(x)).numpy()
    assert got_q.shape == (2, 16)
    assert np.abs(got_fp - want_fp).max() <= PLAIN_REL * np.abs(want_fp).max()


def test_cnn_example_runs_on_cpu(capsys):
    example = runpy.run_path(str(Path(__file__).resolve().parents[1] / "examples"
                                 / "cnn_paper_repro_torch.py"))
    assert example["main"](["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "feature cosine" in out and out.rstrip().endswith("OK")
