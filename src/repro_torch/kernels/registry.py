"""KernelOp registry — the single dispatch surface for the port's kernels.

The port's counterpart of ``repro/kernels/registry.py``: an op states once
its plain PyTorch version (``plain``) and its CUDA kernel wrapper
(``kernel``), and every caller goes through ``dispatch(name, *arrays,
backend=..., **static)`` with the reference's op names and positional
arity (optional operands are ``None`` slots).

Backends:
  'auto'  follows the tensors' device: CUDA tensors go to the kernel (which
          launches or raises), CPU tensors to the plain version
  'cuda'  the kernel; CPU tensors raise
  'ref'   the plain version on whatever device the tensors lie on (the
          kernel-versus-plain comparison on the card uses this)

Every dispatch records ``kernel_dispatch_total{op,backend,m_bucket,bits}``
(obs/metrics.py), counted per call. Registered: the GEMMs ``lut_gemm``,
``dequant_matmul``, ``lut_gemm_bs_fused`` and the two-step
``lut_gemm_bitsliced``, the per-expert GEMMs of the MoE path,
``expert_dequant_matmul`` and ``expert_lut_gemm``, paged decode attention,
``paged_attention`` and ``paged_attention_splitkv`` (a local layer passes
its ``window`` as a static argument, which reaches the kernel and the
plain version alike; a ring-paged one its ring as an absolute block
table, kernels/paged_attention.py), and decode attention over the
fixed-batch loop's dense slot cache, ``kv_cache_attention`` (a local
layer's ring needs no window: its lengths are the ring's live rows).
LUT-65k has no kernel and is not registered.

Tensor parallelism: the four dense GEMM ops carry the reference's TP rule
(``tp_rule``, the shard axis of each operand for a role). While a
``dist.sharding.use_tp`` context is active, ``dispatch(..., tp=role)``
honours it. The weight operands arrive as the rank's slice, cut once at
load time (``core/qlinear.py::shard_weight``), and the activations arrive
whole on every rank:

  col  the op runs on the whole activations and the rank's N slice; the
       outputs are gathered along N
  row  the activation operand is cut to the rank's K range, the op runs on
       it and the rank's K slice; the outputs are summed over the ranks

A leaf whose shard axes do not all divide by the rank count (``tp_split``
returns None) is never cut and runs whole on every rank, as in the
reference. The expert ops' rules wait (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.dist import sharding
from repro_torch.obs import metrics as obs_metrics
from .expert_gemm import (expert_dequant_matmul_cuda, expert_dequant_matmul_plain,
                          expert_lut_gemm_cuda, expert_lut_gemm_plain)
from .kv_cache_attention import kv_cache_attention_cuda, kv_cache_attention_plain
from .lut_dequant_matmul import dequant_matmul_cuda, dequant_matmul_plain
from .lut_gemm import lut_gemm_cuda, lut_gemm_plain
from .lut_gemm_bitsliced import (lut_gemm_bitsliced_cuda, lut_gemm_bitsliced_plain,
                                 lut_gemm_bs_fused_cuda, lut_gemm_bs_fused_plain)
from .paged_attention import (paged_attention_cuda, paged_attention_plain,
                              paged_attention_splitkv_cuda,
                              paged_attention_splitkv_plain)

BACKENDS = ("auto", "cuda", "ref")


@dataclasses.dataclass(frozen=True)
class KernelOp:
    name: str
    plain: Callable[..., torch.Tensor]
    kernel: Callable[..., torch.Tensor]
    doc: str = ""
    # (role, static) -> the shard axis of each operand (None: whole on every
    # rank), or None where the op has no rule for the role; slot 0 is the
    # activation operand
    tp_rule: Optional[Callable[[str, dict], Optional[tuple]]] = None


_REGISTRY: dict[str, KernelOp] = {}


def register(op: KernelOp) -> KernelOp:
    if op.name in _REGISTRY:
        raise ValueError(f"duplicate kernel op {op.name!r}")
    _REGISTRY[op.name] = op
    return op


def get(name: str) -> KernelOp:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel op {name!r}; registered: "
                       f"{op_names()}") from None


def op_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_backend(backend: str, device: torch.device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend != "auto":
        return backend
    return "cuda" if device.type == "cuda" else "ref"


def dispatch(name: str, *arrays: torch.Tensor | None, backend: str = "auto",
             tp: Optional[str] = None, **static: Any) -> torch.Tensor:
    """Run a registered op on ``arrays`` (``None`` marks an optional slot).
    ``tp`` is the leaf's TP role, honoured while ``use_tp`` is active."""
    op = get(name)
    first = next(x for x in arrays if x is not None)
    b = resolve_backend(backend, first.device)
    m = next((int(x.shape[0]) for x in arrays
              if x is not None and x.ndim >= 2), None)
    obs_metrics.record_kernel_dispatch(
        op.name, b, m=m, bits=static.get("w_bits", static.get("bits")))
    fn = op.plain if b == "ref" else op.kernel
    ctx = sharding.active_tp() if tp is not None else None
    axes = op.tp_rule(tp, static) if ctx is not None and op.tp_rule else None
    if axes is None:
        return fn(*arrays, **static)
    if tp == "col":
        return sharding.gather_cols(fn(*arrays, **static), ctx)
    a, ax = arrays[0], axes[0]
    if a.shape[ax] % ctx.world:
        raise ValueError(f"{name}: the activations' K {a.shape[ax]} does not "
                         f"split over {ctx.world} ranks")
    k = a.shape[ax] // ctx.world
    part = fn(a.narrow(ax, ctx.rank * k, k).contiguous(), *arrays[1:], **static)
    return sharding.sum_ranks(part, ctx)


def launch_counts() -> dict[str, int]:
    """Every registered op's kernel launches so far in this process (each
    wrapper counts its own launches)."""
    return {name: op.kernel.launches for name, op in _REGISTRY.items()}


def tp_split(name: str, role: str, static: dict, shapes: tuple,
             world: int) -> Optional[tuple]:
    """The shard axis of each operand of ``name`` for ``role`` over
    ``world`` ranks, given the operands' whole shapes (None for an empty
    slot); None when the op has no rule for the role or a sharded axis does
    not divide by ``world`` (the leaf then stays whole on every rank)."""
    rule = get(name).tp_rule
    axes = rule(role, static) if rule is not None else None
    if axes is None or any(ax is not None and shape is not None
                           and shape[ax] % world
                           for ax, shape in zip(axes, shapes)):
        return None
    return axes


@contextlib.contextmanager
def checked_against_plain(names, errs: list):
    """While active, every call the registry sends to the kernel of an op
    in ``names`` is also run through the op's plain version on the same
    inputs (no launch), and max|kernel - plain| / max|plain| of each call
    is appended to ``errs``: how ``chip_smoke.py`` and the card's tests hold
    a kernel against its plain version inside a served step."""
    saved = {name: get(name) for name in names}

    def checking(op):
        def kernel(*arrays, **static):
            out = op.kernel(*arrays, **static)
            want = op.plain(*arrays, **static)
            den = want.abs().max().clamp_min(torch.finfo(torch.float32).tiny)
            errs.append(((out - want).abs().max() / den).item())
            return out
        return kernel

    for name, op in saved.items():
        _REGISTRY[name] = dataclasses.replace(op, kernel=checking(op))
    try:
        yield
    finally:
        _REGISTRY.update(saved)


# TP rules: the reference's (kernels/registry.py:175-274 there), over the
# full positional arity; a rule says where each operand is cut, and
# ``tp_split`` adds the reference's divisibility conditions.

def _lut_gemm_tp(role, static):
    # (a_packed, w_packed, lut_table, w_scales|None)
    return (None, 0, None, 0) if role == "col" else (-1, -1, None, -1)


def _dequant_matmul_tp(role, static):
    # (a, w_packed, codebook, scales): per-channel scales are applied per
    # output column inside the kernel, which commutes with the sum
    if role == "col":
        return (None, 0, None, 0)
    return (-1, -1, None, -1 if static.get("group_size") is not None else None)


def _bitsliced_tp(role, static):
    # (a_codes, w_planes, w_scales|None): K is cut at pattern granularity,
    # so plane bytes stay whole
    return (None, 1, 0) if role == "col" else (-1, -1, -1)


def _bs_fused_tp(role, static):
    # (x, w_planes, w_scales, a_sc|None): columns only. The dynamic row amax
    # needs the whole K row, so a row leaf takes the two-step route
    # (qlinear.dense_serve)
    return (None, 1, 0, None) if role == "col" else None


register(KernelOp(
    name="lut_gemm", plain=lut_gemm_plain, kernel=lut_gemm_cuda,
    tp_rule=_lut_gemm_tp,
    doc="Paper-faithful product-LUT GEMM: "
        "out[m,n] = sum_k LUT[(w[n,k]<<a_bits)|a[m,k]]. "
        "arrays: (a_packed, w_packed, lut_table, w_scales|None)"))

register(KernelOp(
    name="dequant_matmul", plain=dequant_matmul_plain,
    kernel=dequant_matmul_cuda, tp_rule=_dequant_matmul_tp,
    doc="Packed-weight matmul: (a @ dequant(w).T) * scales. "
        "arrays: (a, w_packed, codebook, scales)"))

register(KernelOp(
    name="lut_gemm_bs_fused", plain=lut_gemm_bs_fused_plain,
    kernel=lut_gemm_bs_fused_cuda, tp_rule=_bs_fused_tp,
    doc="Fused-prologue bit-sliced LUT GEMM: per-row activation quantization "
        "(dynamic row amax or a given f32 a_sc), the bit-plane subset-sum "
        "core and the full weight x activation scale epilogue in one kernel; "
        "raw bf16/f32 activations in, scaled f32 out. "
        "arrays: (x, w_planes, w_scales, a_sc|None)"))

register(KernelOp(
    name="lut_gemm_bitsliced", plain=lut_gemm_bitsliced_plain,
    kernel=lut_gemm_bitsliced_cuda, tp_rule=_bitsliced_tp,
    doc="Two-step bit-sliced LUT GEMM: int8 activation codes against the "
        "bit planes through per-token subset-sum tables; exact integer sums "
        "as f32, or group-scaled partials summed in ascending group order. "
        "The row-parallel route of a bit-sliced leaf. "
        "arrays: (a_codes, w_planes, w_scales|None)"))

register(KernelOp(
    name="expert_dequant_matmul", plain=expert_dequant_matmul_plain,
    kernel=expert_dequant_matmul_cuda,
    doc="Grouped per-expert packed matmul (MoE serving hot-spot): "
        "out[e] = (x[e] @ dequant(w[e]).T) * scales[e]. "
        "arrays: (x, w_packed, codebook, scales)"))

register(KernelOp(
    name="expert_lut_gemm", plain=expert_lut_gemm_plain,
    kernel=expert_lut_gemm_cuda,
    doc="Activation-quantized per-expert LUT GEMM (paper-faithful w{b}a{b} "
        "MoE path). arrays: (a_packed, w_packed, lut_table, w_scales|None)"))

register(KernelOp(
    name="kv_cache_attention", plain=kv_cache_attention_plain,
    kernel=kv_cache_attention_cuda,
    doc="Decode attention over an int8/int4-packed dense KV cache (fused "
        "dequant). arrays: (q, k_packed, k_sc, v_packed, v_sc, lengths)"))

register(KernelOp(
    name="paged_attention", plain=paged_attention_plain,
    kernel=paged_attention_cuda,
    doc="Decode attention over a paged packed KV-cache pool via per-"
        "sequence block tables; window=W keeps rows >= lengths - W. arrays: "
        "(q, k_pool, k_sc, v_pool, v_sc, block_tables, lengths)"))

register(KernelOp(
    name="paged_attention_splitkv", plain=paged_attention_splitkv_plain,
    kernel=paged_attention_splitkv_cuda,
    doc="Flash-decoding paged attention: the block table is partitioned "
        "into kv_splits chunks, each folded by its own online softmax into "
        "(acc, m, l) partials, then merged exactly; window=W keeps rows >= "
        "lengths - W. arrays: (q, k_pool, k_sc, v_pool, v_sc, block_tables, "
        "lengths)"))
