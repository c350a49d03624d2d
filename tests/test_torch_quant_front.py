"""The port's quantization front end against the JAX reference on the CPU:
k-means codebooks (``--nonuniform``), the calibration pass and static
activation scales (``--a-scale static``), the legacy dequant-einsum plan
(``--plan legacy``), and the serve CLI with each flag.

Inputs come from numpy with a seed; the reference's leaves and trees are
carried across with the bridge. Tolerances, each stated where it is used:
- k-means levels within 1e-6 relative of the reference's (a cluster's sum
  runs in float64 in the port, in XLA's f32 order in the reference); codes
  equal except where a value lies within 1e-6 * max|x| of a midpoint of
  two levels; the quantile helper equals ``jnp.quantile``.
- Planned k-means leaves through the plain kernels against the
  reference's ``backend="ref"``: within 1e-5 of max|ref| (a float product
  table sums in another order than the reference's dequant dot).
- Calibration amax within 1e-4 relative (float32 model: the two forwards
  differ in summation order); static scales bit-equal from the same
  stats; logits of the static and legacy models within the 1e-4 of
  tests/test_torch_model.py's float32 parity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduce_for_smoke as jreduce
from repro.core import calibrate as jcal, qlinear as jqlinear, qplan as jqplan
from repro.core import quant as jquant
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import calibrate, qlinear, qplan, quant
from repro_torch.launch import serve
from repro_torch.models import lm

KEY = jax.random.PRNGKey(0)
LEVEL_REL = 1e-6
MID_REL = 1e-6
SERVE_REL = 1e-5
AMAX_REL = 1e-4
F32_TOL = 1e-4


def _np(x):
    return np.asarray(x)


def _weights(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_quantile_equals_jnp_quantile():
    x = np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
    for k in (4, 16):
        qs = np.array(jnp.linspace(0.0, 1.0, k + 2)[1:-1])
        want = _np(jnp.quantile(jnp.asarray(x), jnp.asarray(qs)))
        got = quant.quantile(torch.from_numpy(x), torch.from_numpy(qs)).numpy()
        np.testing.assert_array_equal(got, want)


def _codes_agree(x, levels, got_idx, want_idx):
    """Codes equal except where x lies within MID_REL * max|x| of a
    midpoint of two neighbouring levels."""
    mids = (levels[1:] + levels[:-1]) / 2
    near = (np.abs(x[..., None] - mids) <= MID_REL * np.abs(x).max()).any(-1)
    assert ((got_idx == want_idx) | near).all()


@pytest.mark.parametrize("bits,shape", [(2, (48, 200)), (4, (96, 130))])
def test_kmeans_codebook_matches_reference(bits, shape):
    x = _weights(bits, shape)
    want = _np(jquant.kmeans_codebook(jnp.asarray(x), bits).levels)
    cb = quant.kmeans_codebook(torch.from_numpy(x), bits)
    np.testing.assert_allclose(cb.levels.numpy(), want, rtol=LEVEL_REL, atol=0)
    assert (np.diff(cb.levels.numpy()) > 0).all()
    idx = quant.codebook_quantize(torch.from_numpy(x), cb).numpy()
    jidx = _np(jquant.codebook_quantize(jnp.asarray(x), jquant.Codebook(jnp.asarray(want))))
    assert idx.dtype == np.uint8 and idx.shape == shape
    _codes_agree(x, want, idx, jidx)
    np.testing.assert_array_equal(
        quant.codebook_dequantize(torch.from_numpy(idx), cb).numpy(),
        cb.levels.numpy()[idx])


def _kmeans_pair(plan_kw, in_f=72, out_f=40, seed=3):
    w = _weights(seed, (in_f, out_f))
    jq = jqlinear.quantize_weight(jnp.asarray(w), jqlinear.QuantPolicy(**plan_kw))
    tq = qlinear.quantize_weight(torch.from_numpy(w), qlinear.QuantPolicy(**plan_kw))
    return w, jq, tq


@pytest.mark.parametrize("plan_kw", [
    dict(w_bits=2, a_bits=2, nonuniform=True, kernel="auto"),
    dict(w_bits=2, nonuniform=True, kernel="auto")])
def test_kmeans_leaves_serve_like_the_reference(plan_kw):
    """The port's k-means leaf against the reference's (levels, unit scales,
    codes, the float product table), and the plain dense_serve on the
    reference's leaf carried across against the reference's 'ref'
    backend."""
    w, jq, tq = _kmeans_pair(plan_kw)
    jl = _np(jq.codebook)
    np.testing.assert_allclose(tq.codebook.numpy(), jl, rtol=LEVEL_REL, atol=0)
    np.testing.assert_array_equal(tq.scales.numpy(), np.ones(w.shape[1], np.float32))
    wt = np.pad(w.T, ((0, 0), (0, tq.k_padded - w.shape[0])))
    _codes_agree(wt, jl, tq.unpacked_idx().numpy(), _np(jq.unpacked_idx()))
    assert (tq.plut is None) == (jq.plut is None) and tq.kernel == jq.kernel
    if jq.plut is not None:
        np.testing.assert_allclose(tq.plut.numpy(), _np(jq.plut), rtol=LEVEL_REL,
                                   atol=0)
    x = np.random.default_rng(5).standard_normal((13, w.shape[0])).astype(np.float32)
    want = _np(jqlinear.dense_serve(jq, jnp.asarray(x), backend="ref"))
    carried = bridge.qweight_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    assert tq.nonuniform and carried.nonuniform
    got = qlinear.dense_serve(carried, torch.from_numpy(x), backend="ref").numpy()
    assert np.abs(got - want).max() <= SERVE_REL * np.abs(want).max()
    mine = qlinear.dense_serve(tq, torch.from_numpy(x), backend="ref").numpy()
    assert np.isfinite(mine).all() and mine.shape == want.shape


def test_the_references_refusals_and_expert_leaves():
    w = torch.from_numpy(_weights(7, (64, 32)))
    with pytest.raises(NotImplementedError, match="k-means"):
        qlinear.quantize_weight(w, qlinear.QuantPolicy(w_bits=2, nonuniform=True,
                                                       group_size=32))
    with pytest.raises(ValueError, match="uniform"):
        qlinear.quantize_weight(w, qlinear.QuantPolicy(
            w_bits=2, a_bits=8, nonuniform=True, kernel="lut_gemm_bitsliced"))
    # expert stacks ignore nonuniform, as the reference's do
    we = _weights(8, (3, 64, 32))
    pol = dict(w_bits=2, a_bits=2, nonuniform=True, kernel="auto")
    jq = jqlinear.quantize_expert_weight(jnp.asarray(we), jqlinear.QuantPolicy(**pol))
    tq = qlinear.quantize_expert_weight(torch.from_numpy(we), qlinear.QuantPolicy(**pol))
    for f in ("packed", "codebook", "scales", "plut"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(), _np(getattr(jq, f)))
    np.testing.assert_array_equal(tq.codebook.numpy(), [-2, -1, 0, 1])


def test_calibrate_primitives_match_reference():
    assert calibrate.observe("attn.wq", torch.ones(2, 4)) is None
    with calibrate.collect_act_stats() as stats:
        calibrate.observe("attn.wq", torch.full((2, 4), 3.0))
        calibrate.observe("attn.wq", torch.full((2, 4), -5.0))
        calibrate.observe("mlp.w_up", torch.zeros(3))       # amax 0: not recorded
    assert stats == {"attn.wq": 5.0}
    s = {"attn.wq": 2.5, "wq": 9.0, "mlp.w_up": 1.0}
    for tag in ("layers.0.attn.wq", "attn.wq", "blocks.l0.mlp.w_up", "x.wq", "nope"):
        assert calibrate.lookup(s, tag) == jcal.lookup(s, tag)
    for amax, bits in ((3.7, 2), (0.0, 8), (12.25, 4)):
        assert calibrate.static_scale(amax, bits) == jcal.static_scale(amax, bits)


def _qwen_cfgs(quant_j, quant_t, n_layers=2):
    jc = dataclasses.replace(jreduce(jget_config("qwen1.5-0.5b")), n_layers=n_layers,
                             dtype="float32", quant=quant_j)
    tc = dataclasses.replace(reduce_for_smoke(get_config("qwen1.5-0.5b")),
                             n_layers=n_layers, dtype="float32", quant=quant_t)
    return jc, tc


_PARAMS = {}


def _ref_params(jc):
    """The reference's plain weights for ``jc``'s arch and depth, drawn once
    under jit (the plan does not enter them)."""
    key = (jc.name, jc.n_layers)
    if key not in _PARAMS:
        _PARAMS[key] = jax.jit(lambda k: jlm.init_params(k, jc))(KEY)
    return _PARAMS[key]


def _jit_pack(params, jc, act_scales=None):
    """The reference's quantize_tree under jit, as its serve CLI runs it."""
    return jax.jit(lambda p: jlm.quantize_tree(p, jc, act_scales=act_scales))(params)


def _tokens(cfg, n=3, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
            for _ in range(n)]


def _static_plans():
    """w2a2 static everywhere but attention, which takes the bit-sliced
    route (also static: the reference keeps it dynamic)."""
    bs = dict(w_bits=2, a_bits=8, kernel="lut_gemm_bitsliced", a_scale="static")
    return (jqplan.make_plan(2, 2, a_scale="static", backend="ref",
                             rules=(("attn", jqlinear.QuantPolicy(**bs)),)),
            qplan.make_plan(2, 2, a_scale="static", backend="ref",
                            rules=(("attn", qlinear.QuantPolicy(**bs)),)))


def test_calibration_and_static_scales_match_reference():
    jp, tp = _static_plans()
    jc, tc = _qwen_cfgs(jp, tp)
    params = _ref_params(jc)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    toks = _tokens(jc)
    jstats = jlm.calibrate_act_scales(params, jc, [{"tokens": jnp.asarray(t)} for t in toks])
    tstats = lm.calibrate_act_scales(tparams, tc,
                                     [{"tokens": torch.from_numpy(t).long()} for t in toks])
    assert sorted(tstats) == sorted(jstats) and len(tstats) == 7
    for k, v in jstats.items():
        assert abs(tstats[k] - v) <= AMAX_REL * v, (k, tstats[k], v)
    # the reference's stats, one layer class left out (it stays dynamic)
    stats = {k: v for k, v in jstats.items() if k != "mlp.w_down"}
    jq = _jit_pack(params, jc, stats)
    ref = bridge.qparams_from_jax(jax.tree.map(np.asarray, jq), tc, device="cpu")
    mine = lm.quantize_tree(tparams, tc, act_scales=stats)
    stamped = 0
    for path, qw in lm.qweights(mine).items():
        want = lm.qweights(ref)[path]
        assert (qw.a_sc is None) == (want.a_sc is None), path
        if qw.a_sc is not None:
            assert qw.kernel == "lut_gemm" and "w_down" not in path
            assert qw.a_sc.item() == want.a_sc.item()
            stamped += 1
    assert stamped == 2 * 2                      # w_gate, w_up in each layer
    # the static model against the reference's, float32 logits
    tok = toks[0]
    jh, _ = jlm.forward(jq, jc, jnp.asarray(tok))
    th, _ = lm.forward(ref, tc, torch.from_numpy(tok).long())
    np.testing.assert_allclose(lm.logits_fn(ref, tc, th).numpy(),
                               _np(jlm.logits_fn(jq, jc, jh)), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "moonshot-v1-16b-a3b"])
def test_legacy_plan_matches_reference(arch):
    """``--plan legacy``: one kernel-less policy packs every layer but its
    skip list (dense, expert and shared-expert leaves); the forward is the
    reference's dequant-einsum form. The port's own packing gives the
    reference's leaves bit for bit; the logits agree within F32_TOL."""
    depth = 2 if arch == "qwen1.5-0.5b" else 1
    jc = dataclasses.replace(jreduce(jget_config(arch)), n_layers=depth, dtype="float32",
                             quant=jqlinear.QuantPolicy(w_bits=2))
    tc = dataclasses.replace(reduce_for_smoke(get_config(arch)), n_layers=depth,
                             dtype="float32", quant=qlinear.QuantPolicy(w_bits=2))
    params = _ref_params(jc)
    jq = _jit_pack(params, jc)
    ref = bridge.qparams_from_jax(jax.tree.map(np.asarray, jq), tc, device="cpu")
    mine = lm.quantize_tree(bridge.params_from_jax(jax.tree.map(np.asarray, params), tc,
                                                   device="cpu"), tc)
    leaves = lm.qweights(mine)
    assert leaves and all(qw.kernel is None for qw in leaves.values())
    for path, qw in leaves.items():
        want = lm.qweights(ref)[path]
        for f in ("packed", "codebook", "scales"):
            np.testing.assert_array_equal(getattr(qw, f).numpy(), getattr(want, f).numpy())
    tok = _tokens(jc, 1)[0]
    jh, _ = jlm.forward(jq, jc, jnp.asarray(tok))
    th, _ = lm.forward(mine, tc, torch.from_numpy(tok).long())
    np.testing.assert_allclose(lm.logits_fn(mine, tc, th).numpy(),
                               _np(jlm.logits_fn(jq, jc, jh)), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("flags,dispatch", [
    (["--nonuniform"], "dequant_matmul:ref"),
    (["--plan", "w2a2", "--nonuniform"], "lut_gemm:ref"),
    (["--plan", "w2a2", "--a-scale", "static", "--calib-batches", "2"], "lut_gemm:ref"),
    (["--plan", "legacy"], None)])
def test_serve_cli_quant_front_flags_on_cpu(flags, dispatch, capsys):
    assert serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                       "--paged", "--requests", "4", "--gen", "6", *flags]) == 0
    out = capsys.readouterr().out
    assert "4/4 requests" in out
    assert ("k-means codebook" in out) == ("--nonuniform" in flags)
    assert ("calibrated 7 layer classes over 2 batches" in out) == ("static" in flags)
    ops = out.split("kernel dispatches: ")[-1].strip()
    if dispatch is None:
        assert ops == "{}"
    else:                  # 7 projections a forward, every one on the op
        assert ops.startswith("{'" + dispatch + "': ") and int(ops.split(": ")[1][:-1]) % 7 == 0
