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
``dequant_matmul`` and ``lut_gemm_bs_fused``, the per-expert GEMMs of the
MoE path, ``expert_dequant_matmul`` and ``expert_lut_gemm``, paged decode
attention, ``paged_attention`` and ``paged_attention_splitkv``, and decode
attention over the fixed-batch loop's dense slot cache,
``kv_cache_attention``. Tensor-parallel rules (the expert ones included)
wait for the distributed slice (ROADMAP queue 1, item 11); the ops not yet
ported (the two-step ``lut_gemm_bitsliced``, which only the row-TP route
reaches, and LUT-65k, which has no kernel) are not registered.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.obs import metrics as obs_metrics
from .expert_gemm import (expert_dequant_matmul_cuda, expert_dequant_matmul_plain,
                          expert_lut_gemm_cuda, expert_lut_gemm_plain)
from .kv_cache_attention import kv_cache_attention_cuda, kv_cache_attention_plain
from .lut_dequant_matmul import dequant_matmul_cuda, dequant_matmul_plain
from .lut_gemm import lut_gemm_cuda, lut_gemm_plain
from .lut_gemm_bitsliced import lut_gemm_bs_fused_cuda, lut_gemm_bs_fused_plain
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
             **static: Any) -> torch.Tensor:
    """Run a registered op on ``arrays`` (``None`` marks an optional slot)."""
    op = get(name)
    first = next(x for x in arrays if x is not None)
    b = resolve_backend(backend, first.device)
    m = next((int(x.shape[0]) for x in arrays
              if x is not None and x.ndim >= 2), None)
    obs_metrics.record_kernel_dispatch(
        op.name, b, m=m, bits=static.get("w_bits", static.get("bits")))
    fn = op.plain if b == "ref" else op.kernel
    return fn(*arrays, **static)


register(KernelOp(
    name="lut_gemm", plain=lut_gemm_plain, kernel=lut_gemm_cuda,
    doc="Paper-faithful product-LUT GEMM: "
        "out[m,n] = sum_k LUT[(w[n,k]<<a_bits)|a[m,k]]. "
        "arrays: (a_packed, w_packed, lut_table, w_scales|None)"))

register(KernelOp(
    name="dequant_matmul", plain=dequant_matmul_plain,
    kernel=dequant_matmul_cuda,
    doc="Packed-weight matmul: (a @ dequant(w).T) * scales. "
        "arrays: (a, w_packed, codebook, scales)"))

register(KernelOp(
    name="lut_gemm_bs_fused", plain=lut_gemm_bs_fused_plain,
    kernel=lut_gemm_bs_fused_cuda,
    doc="Fused-prologue bit-sliced LUT GEMM: per-row activation quantization "
        "(dynamic row amax or a given f32 a_sc), the bit-plane subset-sum "
        "core and the full weight x activation scale epilogue in one kernel; "
        "raw bf16/f32 activations in, scaled f32 out. "
        "arrays: (x, w_planes, w_scales, a_sc|None)"))

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
        "sequence block tables. arrays: (q, k_pool, k_sc, v_pool, v_sc, "
        "block_tables, lengths)"))

register(KernelOp(
    name="paged_attention_splitkv", plain=paged_attention_splitkv_plain,
    kernel=paged_attention_splitkv_cuda,
    doc="Flash-decoding paged attention: the block table is partitioned "
        "into kv_splits chunks, each folded by its own online softmax into "
        "(acc, m, l) partials, then merged exactly. arrays: (q, k_pool, "
        "k_sc, v_pool, v_sc, block_tables, lengths)"))
