"""The port's core (packing, quantizers, product LUTs, packed leaves, plans)
against the JAX reference on the same numpy inputs. Everything here must
match bit for bit: the port repeats the reference's integer and IEEE f32 /
bf16 arithmetic op for op. Also: the port imports neither jax nor repro."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking, qlinear as jqlinear
from repro.core import qplan as jqplan, quant as jquant
from repro.core.lut import product_lut as jproduct_lut
from repro_torch.core import packing, qlinear, qplan, quant
from repro_torch.core.lut import product_lut

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    """JAX array -> numpy; bfloat16 as its raw 16-bit pattern."""
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    """torch tensor -> numpy; bfloat16 as its raw 16-bit pattern."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _eq(jx, tx):
    np.testing.assert_array_equal(_np(jx), _tnp(tx))


# --------------------------------------------------------------------------- #
# Import hygiene
# --------------------------------------------------------------------------- #

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "attn_sweep.py"]
    assert len(files) > 10
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


# --------------------------------------------------------------------------- #
# Packing
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_pack_unpack_bit_identical(bits):
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 2 ** bits, size=(5, 48)).astype(np.uint8)
    jp = jpacking.pack(jnp.asarray(idx), bits)
    tp = packing.pack(torch.from_numpy(idx), bits)
    _eq(jp, tp)
    _eq(jpacking.unpack(jp, bits), packing.unpack(tp, bits))
    _eq(jpacking.pack_indexready(jnp.asarray(idx), bits),
        packing.pack_indexready(torch.from_numpy(idx), bits))


# --------------------------------------------------------------------------- #
# Quantizers, codebooks, LUTs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("bits,signed", [(2, True), (4, True), (8, True), (2, False)])
def test_codebook_and_product_lut_bit_identical(bits, signed):
    assert quant.qrange(bits, signed) == jquant.qrange(bits, signed)
    _eq(jquant.uniform_codebook(bits, signed).levels,
        quant.uniform_codebook(bits, signed).levels)
    for a_bits in (2, 8):
        jl = jproduct_lut(jquant.uniform_codebook(bits, signed),
                          jquant.uniform_codebook(a_bits, True))
        tl = product_lut(quant.uniform_codebook(bits, signed),
                         quant.uniform_codebook(a_bits, True))
        _eq(jl.table, tl.table)
        assert (jl.w_bits, jl.a_bits) == (tl.w_bits, tl.a_bits)


@pytest.mark.parametrize("group", [None, 16, 64])
def test_scales_codes_bit_identical_f32(group):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 128)).astype(np.float32)
    x[2] = 0.0                                   # an all-zero row hits eps
    for bits in (2, 4):
        js = jquant.group_scales(jnp.asarray(x), bits, group)
        ts = quant.group_scales(torch.from_numpy(x), bits, group)
        _eq(js, ts)
        if group is not None:
            _eq(jquant.expand_group_scales(js, group),
                quant.expand_group_scales(ts, group))
        jfull = js[..., None] if group is None else jquant.expand_group_scales(js, group)
        tfull = ts[..., None] if group is None else quant.expand_group_scales(ts, group)
        jq = jquant.quantize(jnp.asarray(x), jfull, bits=bits)
        tq = quant.quantize(torch.from_numpy(x), tfull, bits=bits)
        _eq(jq, tq)
        _eq(jquant.to_index(jq, bits), quant.to_index(tq, bits))


@pytest.mark.parametrize("a_bits", [2, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dynamic_activation_codes_bit_identical(a_bits, dtype):
    """Per-row dynamic activation quantization as dense_serve runs it: amax
    and scale in the input dtype (bf16 stays bf16), divide, round half to
    even. Values are drawn so many land exactly on .5 rounding ties."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(9, 64)).astype(np.float32)
    x[:, :8] = np.round(x[:, :8] * 4) / 4       # exact quarters -> ties
    x[3] = 0.0
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    js, _ = jquant.compute_scale_zero_point(jx, a_bits, signed=True, axis=0)
    ts, _ = quant.compute_scale_zero_point(tx, a_bits, signed=True, axis=0)
    assert ts.dtype == tx.dtype
    _eq(js, ts)
    jq = jquant.quantize(jx, js, bits=a_bits, signed=True)
    tq = quant.quantize(tx, ts, bits=a_bits, signed=True)
    _eq(jq, tq)
    _eq(jquant.to_index(jq, a_bits), quant.to_index(tq, a_bits))
    _eq(jpacking.pack(jquant.to_index(jq, a_bits), a_bits),
        packing.pack(quant.to_index(tq, a_bits), a_bits))


# --------------------------------------------------------------------------- #
# Packed leaves
# --------------------------------------------------------------------------- #

_LEAF_CASES = [(w, a, g) for w in (2, 4) for a in (None, 2, 8)
               for g in (None, 64, 128)]


@pytest.mark.parametrize("w_bits,a_bits,group", _LEAF_CASES)
def test_quantize_weight_leaves_bit_identical(w_bits, a_bits, group):
    rng = np.random.default_rng(w_bits * 100 + (a_bits or 0) + (group or 0))
    w = (rng.normal(size=(200, 48)) * 0.1).astype(np.float32)   # K=200: padded
    kw = dict(w_bits=w_bits, a_bits=a_bits, group_size=group, kernel="auto")
    jq = jqlinear.quantize_weight(jnp.asarray(w), jqlinear.QuantPolicy(**kw))
    tq = qlinear.quantize_weight(torch.from_numpy(w), qlinear.QuantPolicy(**kw))
    for name in ("packed", "codebook", "scales", "a_levels", "plut"):
        jv, tv = getattr(jq, name), getattr(tq, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            _eq(jv, tv)
            assert tv.is_contiguous(), name          # what the kernels read
    for name in ("bits", "in_features", "out_features", "group_size", "a_bits",
                 "scheme", "kernel", "k_padded"):
        assert getattr(jq, name) == getattr(tq, name), name
    _eq(jqlinear.dequant_weight(jq), qlinear.dequant_weight(tq))


@pytest.mark.parametrize("plan", ["w2a2", "w2a16", "w2a2g64", "w4a8"])
def test_dense_serve_matches_reference(plan):
    """dense_serve end to end (K and M padding, activation quant, kernel op,
    epilogue, bias) on bf16 activations: the LUT core is exact and the
    epilogue is the same ops, so per-channel w{b}a{b} is bit-identical;
    the float routes agree within one bf16 ulp of the output (1e-2)."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(200, 40)) * 0.1).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    x = rng.normal(size=(3, 5, 200)).astype(np.float32)       # 15 rows: M pad
    jpol = jqplan.get_plan(plan).rules[-1][1]
    tpol = qplan.get_plan(plan).rules[-1][1]
    jq = jqlinear.quantize_weight(jnp.asarray(w), jpol)
    tq = qlinear.quantize_weight(torch.from_numpy(w), tpol)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jy = jqlinear.dense_serve(jq, jx, bias=jnp.asarray(b).astype(jnp.bfloat16),
                              backend="ref")
    ty = qlinear.dense_serve(tq, tx, bias=torch.from_numpy(b).to(torch.bfloat16),
                             backend="ref")
    assert ty.dtype == torch.bfloat16 and ty.shape == (3, 5, 40)
    if plan in ("w2a2", "w4a8"):
        _eq(jy, ty)
    else:
        np.testing.assert_allclose(np.asarray(jy, np.float32), ty.float().numpy(),
                                   rtol=1e-2, atol=1e-2)   # one bf16 ulp


def test_plan_rules_resolve_like_reference():
    tags = ["layers.0.attn.wq", "blocks.l0.attn.wo", "layers.3.mlp.w_down",
            "tok_embed", "final_norm", "layers.1.ln1", "lm_head", "pos_embed"]
    for name in jqplan.PLANS:
        for tag in tags:
            jp = jqplan.PLANS[name].policy_for(tag)
            tp = qplan.PLANS[name].policy_for(tag)
            assert (jp is None) == (tp is None), (name, tag)
            if jp is not None:
                for f in ("w_bits", "a_bits", "group_size", "signed", "scheme",
                          "kernel", "a_scale"):
                    assert getattr(jp, f) == getattr(tp, f), (name, tag, f)
                assert jp.resolved_kernel() == tp.resolved_kernel()


def test_bitsliced_leaves_pack_as_scheme_bs():
    """Bit-sliced leaves pack into signed bit planes and serve through the
    fused op."""
    qw = qlinear.quantize_weight(torch.zeros((64, 8)), qplan.get_plan(
        "w2a8_bs").rules[-1][1])
    assert qw.scheme == "bs" and tuple(qw.packed.shape) == (2, 8, 16)


def test_bitsliced_plan_raises_and_points_at_its_slice():
    """A row-parallel bit-sliced leaf, which the reference serves through the
    two-step lut_gemm_bitsliced route under a TP mesh, now comes across with
    its role and its rank slices; what the TP slice left for later, an
    expert leaf with a role, is refused with its ROADMAP item."""
    from repro_torch import bridge
    pol = jqplan.get_plan("w2a8_bs").rules[-1][1]
    leaf = jax.tree.map(np.asarray, jqlinear.quantize_weight(
        jnp.zeros((64, 8)), pol, tp_role="row", tp_shards=2))
    whole = bridge._qw_from(leaf, None, "cpu")
    half = bridge._qw_from(leaf, None, "cpu", tp_rank=1, tp_size=2)
    assert whole.tp == half.tp == "row" and half.k_padded == whole.k_padded == 64
    assert tuple(half.packed.shape) == (2, 8, 8)
    epol = jqplan.get_plan("w2a16").rules[-1][1]
    expert = jqlinear.quantize_expert_weight(jnp.zeros((2, 64, 8)), epol,
                                             tp_role="row", tp_shards=2)
    with pytest.raises(NotImplementedError, match="expert.*queue 1, item 11"):
        bridge._convert({"we_down": jax.tree.map(np.asarray, expert)}, None, "cpu")
    assert jax.default_backend() == "cpu"
