"""The port's dense model against the JAX reference on the reduced
qwen1.5-0.5b (two layers): JAX's weights carried across with the bridge,
layer-by-layer hidden states and the logits under planned (w2a2, w2a16)
serving, with the reference on its 'ref' backend.

Tolerances: float32 configs 1e-4 (relative and absolute; the LUT core is
exact, the rest differs only in f32 summation order and transcendental
ulps). bfloat16 layers are bit-identical to the reference run op by op
(eagerly): the port rounds to bf16 after every op as it does. Under jit
(lm.forward's scan) XLA fuses ops and drops some of those roundings, so
the reference moves away from its own eager result; the jitted logits are
compared by relative norm, 2e-2, under w2a16. Under w2a2 a one-ulp move
flips 2-bit activation codes: the jitted reference differs from its own
eager layer by ~15% relative norm, so the port is held to the eager chain
there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduce_for_smoke as jreduce
from repro.core import qplan as jqplan
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import qplan
from repro_torch.core.qlinear import QuantizedWeight
from repro_torch.models import lm

KEY = jax.random.PRNGKey(0)
F32_TOL = 1e-4
BF16_REL = 2e-2


def _cfgs(plan: str, dtype: str, n_layers: int = 2):
    jc = dataclasses.replace(jreduce(jget_config("qwen1.5-0.5b")), n_layers=n_layers,
                             dtype=dtype, quant=jqplan.make_plan(
                                 **_PLAN_KW[plan], backend="ref"))
    tc = dataclasses.replace(reduce_for_smoke(get_config("qwen1.5-0.5b")),
                             n_layers=n_layers, dtype=dtype,
                             quant=qplan.make_plan(**_PLAN_KW[plan], backend="ref"))
    return jc, tc


_PLAN_KW = {"w2a2": dict(w_bits=2, a_bits=2), "w2a16": dict(w_bits=2),
            "w2a2g64": dict(w_bits=2, a_bits=2, group_size=64),
            "w4a16": dict(w_bits=4)}


def _setup(plan, dtype):
    jc, tc = _cfgs(plan, dtype)
    params = jlm.init_params(KEY, jc)
    qp = jlm.quantize_tree(params, jc)
    return jc, tc, params, qp


def _to_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got: torch.Tensor, want, dtype, exact_bf16=True):
    g, w = got.float().numpy(), _to_np(want)
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    elif exact_bf16:
        np.testing.assert_array_equal(g, w)
    else:
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < BF16_REL, rel


def test_bridge_carries_every_array_bit_for_bit():
    jc, tc, params, qp = _setup("w2a2", "bfloat16")
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    assert tp["tok_embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["tok_embed"].view(torch.int16).numpy(),
                                  np.asarray(params["tok_embed"]).view(np.int16))
    assert len(tp["layers"]) == 2
    for i in range(2):
        want = np.asarray(params["blocks"]["l0"]["attn"]["wq"]["w"][i]).view(np.int16)
        np.testing.assert_array_equal(
            tp["layers"][i]["attn"]["wq"]["w"].view(torch.int16).numpy(), want)
    tq = bridge.qparams_from_jax(jax.tree.map(np.asarray, qp), tc, device="cpu")
    qw = tq["layers"][1]["mlp"]["w_down"]["qw"]
    assert isinstance(qw, QuantizedWeight) and qw.kernel == "lut_gemm"
    jqw = qp["blocks"]["l0"]["mlp"]["w_down"]["qw"]
    np.testing.assert_array_equal(qw.packed.numpy(), np.asarray(jqw.packed[1]))
    np.testing.assert_array_equal(qw.plut.numpy(), np.asarray(jqw.plut[1]))


@pytest.mark.parametrize("plan", ["w2a2", "w2a2g64", "w4a16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tree_matches_reference(plan, dtype):
    """The port's own quantize_tree on carried-over plain weights packs
    exactly the reference's leaves."""
    jc, tc, params, qp = _setup(plan, dtype)
    mine = lm.quantize_tree(bridge.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu"), tc)
    ref = bridge.qparams_from_jax(jax.tree.map(np.asarray, qp), tc, device="cpu")
    n = 0
    for lm_, lr in zip(mine["layers"], ref["layers"]):
        for blk in ("attn", "mlp"):
            for name, leaf in lm_[blk].items():
                a, b = leaf["qw"], lr[blk][name]["qw"]
                for f in ("packed", "codebook", "scales", "a_levels", "plut"):
                    x, y = getattr(a, f), getattr(b, f)
                    assert (x is None) == (y is None), f
                    if x is not None:
                        np.testing.assert_array_equal(x.numpy(), y.numpy())
                assert (a.bits, a.group_size, a.a_bits, a.kernel) == \
                    (b.bits, b.group_size, b.a_bits, b.kernel)
                n += 1
    assert n == 14


def test_init_params_matches_reference_structure():
    jc, tc = _cfgs("w2a2", "bfloat16")
    ref = bridge.params_from_jax(jax.tree.map(np.asarray, jlm.init_params(KEY, jc)), tc,
                                 device="cpu")
    mine = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert shapes(mine) == shapes(ref)


@pytest.mark.parametrize("plan", ["w2a2", "w2a16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_hidden_states_and_logits_match_reference(plan, dtype):
    jc, tc, _, qp = _setup(plan, dtype)
    tq = bridge.qparams_from_jax(jax.tree.map(np.asarray, qp), tc, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab_size, size=(2, 11)).astype(np.int32)
    x = jnp.take(qp["tok_embed"], jnp.asarray(tokens), axis=0).astype(jnp.dtype(dtype))
    for i in range(jc.n_layers):     # eager reference, layer by layer
        lp = jax.tree.map(lambda a: a[i], qp["blocks"])["l0"]
        y, _ = jlm._apply_layer(lp, x, cfg=jc, layer_type="global", is_moe=False,
                                mode="plain", positions=None, enc_out=None,
                                cache=None, pos=None)
        got = lm.apply_layer(tq["layers"][i], bridge.to_torch(x, "cpu"), cfg=tc)
        assert got.dtype == lm.torch_dtype(dtype)
        _close(got, y, dtype)       # same input, one layer
        x = y
    eager_h = jlm.L.norm_apply(qp["final_norm"], x, jc.norm)
    th, _ = lm.forward(tq, tc, torch.from_numpy(tokens).long())
    _close(th, eager_h, dtype)
    # f32 logits: only the summation order of the f32 product differs
    np.testing.assert_allclose(lm.logits_fn(tq, tc, th).numpy(),
                               _to_np(jlm.logits_fn(qp, jc, eager_h)),
                               rtol=F32_TOL, atol=1e-6)
    if dtype == "float32" or plan == "w2a16":   # the jitted scan forward
        jh, _ = jlm.forward(qp, jc, jnp.asarray(tokens))
        _close(th, jh, dtype, exact_bf16=False)
        _close(lm.logits_fn(tq, tc, th), jlm.logits_fn(qp, jc, jh), dtype,
               exact_bf16=False)
