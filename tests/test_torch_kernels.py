"""The port's kernels: plain versions against the JAX Pallas kernels (run in
interpret mode) and the reference's ref.py oracles on the CPU, the registry
and wrapper routing. The CUDA kernels against their plain versions on the
card are in test_torch_kernels_gpu.py (no jax there: the card's machine
has none).

Tolerances: lut_gemm with integer LUT entries is bit-identical (every
partial sum is an exact integer in f32); with group scales or float LUTs
the summation order differs, so 1e-5 relative. dequant_matmul sums f32
products in another order than XLA's dot: 1e-5 relative, 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import packing as jpacking
from repro.core.lut import ProductLUT as JProductLUT
from repro.kernels import ref as jref
from repro.kernels.lut_dequant_matmul import dequant_matmul_pallas
from repro.kernels.lut_gemm import lut_gemm_pallas
from repro_torch.core import packing, quant
from repro_torch.core.lut import product_lut
from repro_torch.kernels import build, registry
from repro_torch.kernels.lut_dequant_matmul import (dequant_matmul_cuda,
                                                    dequant_matmul_plain)
from repro_torch.kernels.lut_gemm import lut_gemm_cuda, lut_gemm_plain
from repro_torch.obs import metrics as obs_metrics

RTOL = 1e-5


def _lut_operands(seed, M, K, N, w_bits, a_bits, group=None, integer=True):
    rng = np.random.default_rng(seed)
    a_idx = rng.integers(0, 2 ** a_bits, size=(M, K)).astype(np.uint8)
    w_idx = rng.integers(0, 2 ** w_bits, size=(N, K)).astype(np.uint8)
    if integer:
        lut = product_lut(quant.uniform_codebook(w_bits),
                          quant.uniform_codebook(a_bits)).table.numpy()
    else:
        lut = rng.normal(size=(2 ** (w_bits + a_bits),)).astype(np.float32)
    sc = None
    if group is not None:
        sc = rng.uniform(0.01, 0.1, size=(N, K // group)).astype(np.float32)
    ap = packing.pack(torch.from_numpy(a_idx), a_bits).numpy()
    wp = packing.pack(torch.from_numpy(w_idx), w_bits).numpy()
    return ap, wp, lut, sc


_LUT_CASES = [(M, K, N, wb, ab, g)
              for M in (1, 4, 9)
              for (K, N) in ((128, 32), (256, 96))
              for (wb, ab, g) in ((2, 2, None), (4, 8, None), (2, 2, 64))]


@pytest.mark.parametrize("M,K,N,wb,ab,group", _LUT_CASES)
def test_plain_lut_gemm_matches_pallas_interpret_and_oracle(M, K, N, wb, ab, group):
    ap, wp, lut, sc = _lut_operands(M * K + N, M, K, N, wb, ab, group)
    want_pl = np.asarray(lut_gemm_pallas(
        jnp.asarray(ap), jnp.asarray(wp), jnp.asarray(lut),
        None if sc is None else jnp.asarray(sc), bits=wb, a_bits=ab,
        group_size=group, interpret=True))
    want_ref = np.asarray(jref.ref_lut_gemm(
        jnp.asarray(ap), jnp.asarray(wp), JProductLUT(jnp.asarray(lut), wb, ab),
        None if sc is None else jnp.asarray(sc), group))
    got = lut_gemm_plain(torch.from_numpy(ap), torch.from_numpy(wp),
                         torch.from_numpy(lut),
                         None if sc is None else torch.from_numpy(sc),
                         w_bits=wb, a_bits=ab, group_size=group).numpy()
    assert got.dtype == np.float32 and got.shape == (M, N)
    if group is None:
        np.testing.assert_array_equal(got, want_pl)
        np.testing.assert_array_equal(got, want_ref)
    else:
        np.testing.assert_allclose(got, want_pl, rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=1e-5)


def test_plain_lut_gemm_float_lut_and_k_chunking(monkeypatch):
    """A float LUT, and K walked in several chunks (the full-width memory
    bound) — both within float tolerance of the oracle."""
    from repro_torch.kernels import ref as tref
    ap, wp, lut, _ = _lut_operands(5, 4, 256, 64, 2, 2, integer=False)
    want = np.asarray(jref.ref_lut_gemm(
        jnp.asarray(ap), jnp.asarray(wp), JProductLUT(jnp.asarray(lut), 2, 2)))
    monkeypatch.setattr(tref, "_GATHER_BUDGET", 4 * 64 * 32)   # 8 chunks
    got = lut_gemm_plain(torch.from_numpy(ap), torch.from_numpy(wp),
                         torch.from_numpy(lut), w_bits=2, a_bits=2).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def _dq_operands(seed, M, K, N, bits, group, dtype):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    w_idx = rng.integers(0, 2 ** bits, size=(N, K)).astype(np.uint8)
    cb = quant.uniform_codebook(bits).levels.numpy()
    sc = rng.uniform(0.01, 0.1, size=(N,) if group is None else (N, K // group))
    wp = packing.pack(torch.from_numpy(w_idx), bits).numpy()
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    ja = jnp.asarray(a).astype(jnp.dtype(dtype))
    return ta, ja, wp, cb, sc.astype(np.float32)


_DQ_CASES = [(M, K, N, b, g, dt)
             for M in (1, 4, 9)
             for (K, N) in ((128, 32), (256, 96))
             for (b, g) in ((2, None), (2, 64), (4, None))
             for dt in ("bfloat16", "float32")]


@pytest.mark.parametrize("M,K,N,bits,group,dtype", _DQ_CASES)
def test_plain_dequant_matmul_matches_pallas_interpret_and_oracle(
        M, K, N, bits, group, dtype):
    ta, ja, wp, cb, sc = _dq_operands(M + K + N, M, K, N, bits, group, dtype)
    want_pl = np.asarray(dequant_matmul_pallas(
        ja, jnp.asarray(wp), jnp.asarray(cb), jnp.asarray(sc), bits=bits,
        group_size=group, interpret=True))
    want_ref = np.asarray(jref.ref_dequant_matmul(
        ja, jnp.asarray(wp), jnp.asarray(cb), jnp.asarray(sc), bits, group))
    got = dequant_matmul_plain(ta, torch.from_numpy(wp), torch.from_numpy(cb),
                               torch.from_numpy(sc), bits=bits,
                               group_size=group).numpy()
    assert got.dtype == np.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got, want_pl, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=1e-5)


def test_unpack_matches_reference_kernel_unpack():
    rng = np.random.default_rng(0)
    for bits in (2, 4, 8):
        p = rng.integers(0, 256, size=(3, 16)).astype(np.uint8)
        np.testing.assert_array_equal(
            packing.unpack(torch.from_numpy(p), bits).numpy(),
            np.asarray(jpacking.unpack(jnp.asarray(p), bits)))


# --------------------------------------------------------------------------- #
# Routing: wrappers, registry, build
# --------------------------------------------------------------------------- #

def test_auto_backend_takes_plain_version_for_cpu_tensors_and_counts_nothing():
    ap, wp, lut, _ = _lut_operands(1, 4, 64, 16, 2, 2)
    t = [torch.from_numpy(x) for x in (ap, wp, lut)]
    before = lut_gemm_cuda.launches
    np.testing.assert_array_equal(
        registry.dispatch("lut_gemm", *t, None, w_bits=2, a_bits=2).numpy(),
        lut_gemm_plain(*t, w_bits=2, a_bits=2).numpy())
    assert lut_gemm_cuda.launches == before
    ta, _, wp2, cb, sc = _dq_operands(2, 4, 64, 16, 2, None, "float32")
    args = (ta, torch.from_numpy(wp2), torch.from_numpy(cb), torch.from_numpy(sc))
    before = dequant_matmul_cuda.launches
    np.testing.assert_array_equal(
        registry.dispatch("dequant_matmul", *args, bits=2).numpy(),
        dequant_matmul_plain(*args, bits=2).numpy())
    assert dequant_matmul_cuda.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    ap, wp, lut, _ = _lut_operands(1, 4, 64, 16, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        lut_gemm_cuda(torch.from_numpy(ap), torch.from_numpy(wp),
                      torch.from_numpy(lut), w_bits=2, a_bits=2)
    ta, _, wp2, cb, sc = _dq_operands(2, 4, 64, 16, 2, None, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        dequant_matmul_cuda(ta, torch.from_numpy(wp2), torch.from_numpy(cb),
                            torch.from_numpy(sc), bits=2)


def test_registry_dispatch_backends_and_counter():
    assert registry.op_names() == ("dequant_matmul", "expert_dequant_matmul",
                                   "expert_lut_gemm", "kv_cache_attention",
                                   "lut_gemm", "lut_gemm_bitsliced",
                                   "lut_gemm_bs_fused", "paged_attention",
                                   "paged_attention_splitkv")
    ap, wp, lut, _ = _lut_operands(3, 4, 64, 16, 2, 2)
    t = [torch.from_numpy(x) for x in (ap, wp, lut)]
    with obs_metrics.scoped(isolate=True) as reg:
        y = registry.dispatch("lut_gemm", *t, None, w_bits=2, a_bits=2,
                              group_size=None)
        registry.dispatch("lut_gemm", *t, None, w_bits=2, a_bits=2,
                          backend="ref")
    np.testing.assert_array_equal(
        y.numpy(), lut_gemm_plain(*t, w_bits=2, a_bits=2).numpy())
    assert reg.counter_total("kernel_dispatch_total", op="lut_gemm",
                             backend="ref", m_bucket="4", bits="2") == 2
    with pytest.raises(ValueError, match="CUDA"):
        registry.dispatch("lut_gemm", *t, None, w_bits=2, a_bits=2,
                          backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        registry.dispatch("lut_gemm", *t, None, w_bits=2, a_bits=2,
                          backend="pallas")
    with pytest.raises(KeyError, match="lut65k_gemm"):
        registry.dispatch("lut65k_gemm", *t)


def test_watched_sees_each_kernel_call_and_checks_it_against_plain(monkeypatch):
    """``watched`` hands on_call the operands and output of each call the
    registry sends to a kernel (a stand-in kernel on CPU tensors here, one
    row off its plain version), and ``checked_against_plain`` built on it
    records that call's max|kernel - plain| / max|plain|; both restore the
    op on exit."""
    ap, wp, lut, _ = _lut_operands(5, 4, 64, 16, 2, 2)
    t = [torch.from_numpy(x) for x in (ap, wp, lut)]

    def kernel(*arrays, **static):
        out = lut_gemm_plain(*arrays, **static)
        out[0] += 1.0
        return out

    op = registry.get("lut_gemm")
    monkeypatch.setitem(registry._REGISTRY, "lut_gemm",
                        registry.KernelOp("lut_gemm", plain=op.plain, kernel=kernel))
    calls, errs = [], []
    with registry.watched(("lut_gemm",), lambda o, arrays, static, y:
                          calls.append((arrays, static, y))):
        y = registry.dispatch("lut_gemm", *t, None, w_bits=2, a_bits=2, backend="cuda")
    (arrays, static, seen), = calls
    assert arrays[0] is t[0] and arrays[3] is None and seen is y
    assert static == dict(w_bits=2, a_bits=2)
    with registry.checked_against_plain(("lut_gemm",), errs):
        registry.dispatch("lut_gemm", *t, None, w_bits=2, a_bits=2, backend="cuda")
    want = lut_gemm_plain(*t, w_bits=2, a_bits=2)
    assert errs == [pytest.approx(1.0 / want.abs().max().item())]
    assert registry.get("lut_gemm").kernel is kernel


@pytest.mark.parametrize("plan", ["w2a2", "w2a2g64", "w4a8", "w2a16",
                                  "w2a16g128", "w4a16", "w2a8_bs",
                                  "w2a8_bs_g64", "w4a8_bs"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_serving_operands_pass_the_kernel_checks(monkeypatch, plan, dtype):
    """What dense_serve hands a kernel (packed leaves from quantize_weight,
    packed activation codes, padded rows) passes every check of the kernel
    wrapper except the device one — so on the card the call launches."""
    from repro_torch.core import qlinear, qplan
    from repro_torch.kernels import lut_dequant_matmul as dq, lut_gemm as lg
    from repro_torch.kernels import lut_gemm_bitsliced as bs
    seen = []

    def spy(check, plain):
        def fn(*args, **kw):
            with pytest.raises(ValueError, match="same CUDA device"):
                check(*args, **kw)
            seen.append(check)
            return plain(*args, **kw)
        return fn

    monkeypatch.setitem(registry._REGISTRY, "lut_gemm", registry.KernelOp(
        "lut_gemm", plain=spy(lambda ap, wp, t, sc, *, w_bits, a_bits, group_size,
                              float_table: lg._check(ap, wp, t, sc, w_bits, a_bits,
                                                     group_size),
                              lut_gemm_plain), kernel=None))
    monkeypatch.setitem(registry._REGISTRY, "dequant_matmul", registry.KernelOp(
        "dequant_matmul", plain=spy(lambda a, wp, cb, sc, *, bits, group_size:
                                    dq._check(a, wp, cb, sc, bits, group_size),
                                    dequant_matmul_plain), kernel=None))
    monkeypatch.setitem(registry._REGISTRY, "lut_gemm_bs_fused", registry.KernelOp(
        "lut_gemm_bs_fused", plain=spy(lambda x, wp, sc, asc, *, w_bits, a_bits,
                                       group_size: bs._check(x, wp, sc, asc, w_bits,
                                                             a_bits, group_size),
                                       bs.lut_gemm_bs_fused_plain), kernel=None))
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(256, 96)).astype(np.float32)).to(dtype)
    qw = qlinear.quantize_weight(w, qplan.get_plan(plan).rules[-1][1])
    for rows in (1, 4, 13, 32):
        x = torch.from_numpy(rng.normal(size=(rows, 256)).astype(np.float32))
        y = qlinear.dense_serve(qw, x.to(dtype))
        assert y.shape == (rows, 96) and y.dtype == dtype
    assert len(seen) == 4


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_build_key_follows_sources():
    d = build._digest()
    assert len(d) == 16 and d == build._digest()
    assert {p.stem for p in build.CSRC.glob("*.cu")} == {
        stem for stem, _ in build.SIGNATURES}
