"""Packed serving weights and the planned dense forward (``dense_serve``).

The port's counterpart of ``repro/core/qlinear.py`` for serving:
``QuantPolicy`` (per-layer-class quantization), ``QuantizedWeight`` (packed
codes + codebook + scales + the offline activation codebook and product
LUT), ``quantize_weight`` / ``quantize_expert_weight`` (an (E, in, out)
expert stack) / ``dequant_weight``, and ``dense_serve``, which routes a
planned leaf to its kernel op (the MoE layer routes expert leaves itself,
models/layers.py::_expert_matmul):

  w{b}a16   -> ``dequant_matmul`` (codebook dequant + matmul + scale)
  w{b}a{b}  -> per-row dynamic activation quantization (or the leaf's static
               scale), packed activation codes, ``lut_gemm``
  w{b}a8_bs -> ``lut_gemm_bs_fused`` on the raw activations: the op itself
               quantizes each row, runs the bit-plane core and applies
               every scale (bit-plane leaves, scheme 'bs')

  row-parallel w{b}a8_bs under ``use_tp`` -> the rows are quantized once
               on the replicated activations, then the two-step
               ``lut_gemm_bitsliced`` runs on the rank's K slice and the
               scale epilogue follows the sum over ranks

Tensor parallelism: ``quantize_weight(..., tp_role, tp_shards)`` records a
leaf's Megatron role and pads a row leaf's K so every shard holds whole
packed bytes and scale groups; ``shard_weight`` keeps one rank's slice of
a role-stamped leaf (where the op's TP rule divides, else the whole leaf);
``dense_serve`` passes the role to the registry, which gathers or sums.

One difference from the reference: under the 'ref' backend the reference
runs the w{b}a{b} route as a dequant dot (the GSPMD-shardable form); the
port always dispatches ``lut_gemm`` and its 'ref' backend is the plain LUT
sum. Both sum the same exact integer products per channel.

Non-uniform leaves (``QuantPolicy.nonuniform``): one k-means codebook fit
over the whole padded (out, in_pad) weight, unit scales, and for w{b}a{b}
a float product table, which ``lut_gemm`` and ``dequant_matmul`` take as
they take uniform ones. Legacy leaves (``kernel`` None, a single
``QuantPolicy`` used as the whole config with its ``skip`` list) keep the
reference's dequant-einsum forward (models/layers.py::dense). Plain
layers (``dense_init`` / ``dense_apply``) serve the conv stack
(core/conv.py).

Not ported yet, and raising: QAT, autotuned tiles, and the expert leaves'
TP roles (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch

from . import packing, quant
from .lut import product_lut
from repro_torch.dist import sharding
from repro_torch.kernels import registry as kreg


def _component_parts(component: str) -> list[str]:
    return [component] + (component.split("_") if "_" in component else [])


def tag_matches(pattern: str, tag: str) -> bool:
    """True if ``pattern`` matches ``tag`` on path components: ``"*"``
    matches all; a multi-component pattern must appear as a contiguous run
    of the tag's components; a single component also matches a component's
    underscore-separated words ('norm' matches 'final_norm')."""
    if pattern == "*":
        return True
    pat = [c for c in re.split(r"[./]", pattern) if c]
    tc = [c for c in re.split(r"[./]", tag) if c]
    if not pat or len(pat) > len(tc):
        return False
    if len(pat) == 1:
        return any(pat[0] in _component_parts(c) for c in tc)
    return any(all(tc[i + j] == pat[j] for j in range(len(pat)))
               for i in range(len(tc) - len(pat) + 1))


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-layer-class quantization policy, the rule of a ``QuantPlan``
    (see the reference's docstring). ``kernel`` 'auto' resolves to
    'lut_gemm' when ``a_bits`` is set, else 'dequant_matmul'; 'bf16' pins
    the layer to full precision; None (a legacy policy) keeps the
    dequant-einsum forward. A single policy may stand as the whole config
    (``--plan legacy``): it covers every tag but those its ``skip`` list
    matches."""
    w_bits: Optional[int] = 2
    a_bits: Optional[int] = None
    signed: bool = True
    scheme: str = "d"
    nonuniform: bool = False
    skip: tuple = ("router", "embed", "norm")
    group_size: Optional[int] = None
    kernel: Optional[str] = None
    a_scale: str = "dynamic"

    def applies(self, tag: str) -> bool:
        """Skip entries match on components (``tag_matches``; the
        reference's ``skip_matches`` is that rule), never substrings."""
        return self.w_bits is not None and self.kernel != "bf16" and not any(
            tag_matches(s, tag) for s in self.skip)

    def policy_for(self, tag: str) -> Optional["QuantPolicy"]:
        """The interface of ``QuantPlan``: this policy where it applies."""
        return self if self.applies(tag) else None

    def resolved_kernel(self) -> Optional[str]:
        if self.kernel != "auto":
            return self.kernel
        return "lut_gemm" if self.a_bits is not None else "dequant_matmul"


@dataclasses.dataclass
class QuantizedWeight:
    """Serving-time packed weight for one dense layer (fields as in the
    reference): packed (out, in_pad/f) uint8, codebook (2^bits,) f32,
    scales (out,) or (out, in_pad/G) f32, and for w{b}a{b} leaves the
    activation codebook ``a_levels``, the product LUT ``plut`` and an
    optional static activation scale ``a_sc``. Bit-sliced leaves (scheme
    'bs') hold (bits, out, in_pad/4) planes in ``packed`` and no ``plut``.
    ``tp`` is the leaf's tensor-parallel role ('col', 'row' or None) and
    ``tp_shards`` the number of ranks its arrays are cut over (1: whole);
    ``in_features`` / ``out_features`` stay the whole layer's.
    ``nonuniform`` (the port's own field) marks a k-means codebook: its
    float product table rounds its sums, so ``lut_gemm``'s plain version
    replays the kernel's order for it."""
    packed: torch.Tensor
    codebook: torch.Tensor
    scales: torch.Tensor
    bits: int
    in_features: int
    out_features: int
    group_size: Optional[int] = None
    a_bits: Optional[int] = None
    scheme: str = "a"
    kernel: Optional[str] = None
    a_levels: Optional[torch.Tensor] = None
    plut: Optional[torch.Tensor] = None
    a_sc: Optional[torch.Tensor] = None
    tp: Optional[str] = None
    tp_shards: int = 1
    nonuniform: bool = False

    @property
    def k_padded(self) -> int:
        """The whole layer's padded contraction length."""
        per = packing.BITPLANE_GROUP if self.scheme == "bs" \
            else packing.PACK_FACTOR[self.bits]
        shards = self.tp_shards if self.tp == "row" else 1
        return self.packed.shape[-1] * per * shards

    def unpacked_idx(self) -> torch.Tensor:
        if self.scheme == "bs":
            return packing.unpack_bitplanes_signed(self.packed, self.bits)
        return packing.unpack(self.packed, self.bits)


def _k_multiple(policy: QuantPolicy, tp_shards: int = 1) -> int:
    """Contraction-axis padding unit: the pack factor (or the scale group,
    itself a pack-factor multiple), lcm'd with the activation pack factor
    for w{b}a{b} LUT plans so both operands hold whole packed bytes, and
    with the plane group for the bit-sliced kernel (its activations stay
    unpacked); times the shard count for a row-parallel leaf, so that every
    shard holds whole packed bytes and whole scale groups."""
    m = policy.group_size if policy.group_size is not None \
        else packing.PACK_FACTOR[policy.w_bits]
    kern = policy.resolved_kernel()
    if policy.a_bits is not None and kern == "lut_gemm":
        m = math.lcm(m, packing.PACK_FACTOR[policy.a_bits])
    if kern == "lut_gemm_bitsliced":
        m = math.lcm(m, packing.BITPLANE_GROUP)
    return m * max(tp_shards, 1)


def _pad_k(wt: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the contraction (last) axis to a multiple; the zero code
    dequantizes to exactly 0.0, so padded columns contribute nothing."""
    pad = (-wt.shape[-1]) % multiple
    return torch.nn.functional.pad(wt, (0, pad)) if pad else wt


def _act_tables(policy: QuantPolicy, w_levels: torch.Tensor):
    """The activation codebook and product LUT, precomputed offline for
    w{b}a{b} LUT plans (None otherwise). The bit-sliced route keeps the
    codebook but has no product LUT: its tables are built from the
    activations inside the kernel."""
    kern = policy.resolved_kernel()
    if policy.a_bits is None or kern not in ("lut_gemm", "lut_gemm_bitsliced"):
        return None, None
    a_levels = quant.uniform_codebook(policy.a_bits, True,
                                      device=w_levels.device).levels
    if kern == "lut_gemm_bitsliced":
        return a_levels, None
    return a_levels, product_lut(w_levels, a_levels).table


def _codes(wt: torch.Tensor, bits: int, signed: bool, group_size):
    """(..., out, K) f32 -> (scales (..., out) or (..., out, K/G), unsigned
    storage indices (..., out, K))."""
    if group_size is None:
        scales = quant.group_scales(wt, bits, None, signed=signed)
        sfull = scales[..., None]
    else:
        scales = quant.group_scales(wt, bits, group_size, signed=signed)
        sfull = quant.expand_group_scales(scales, group_size)
    q = quant.quantize(wt, sfull, bits=bits, signed=signed)
    return scales, quant.to_index(q, bits, signed)


def quantize_weight(w: torch.Tensor, policy: QuantPolicy, *,
                    tp_role: Optional[str] = None, tp_shards: int = 1,
                    a_static: Optional[float] = None) -> QuantizedWeight:
    """Offline quantize+pack of one dense weight: w (in, out) -> packed
    (out, in_pad/f), or (bits, out, in_pad/4) bit planes for the bit-sliced
    kernel, on w's device. ``tp_role`` / ``tp_shards`` record the split the
    leaf is packed for: a 'row' leaf's K is padded for ``tp_shards``."""
    bits = policy.w_bits
    if bits is None:
        raise ValueError("quantize_weight needs a policy with w_bits set")
    G = policy.group_size
    if policy.nonuniform and G is not None:
        raise NotImplementedError("group-wise scales with a k-means codebook")
    kern = policy.resolved_kernel() if policy.kernel else None
    if kern == "lut_gemm_bitsliced" and not (policy.signed and not policy.nonuniform
                                             and policy.a_bits is not None):
        raise ValueError("bit-sliced route needs signed uniform w{b}a{b} "
                         "quantization")
    mult = _k_multiple(policy, tp_shards if tp_role == "row" else 1)
    wt = _pad_k(w.T.to(torch.float32).contiguous(), mult)        # (out, in_pad)
    if policy.nonuniform:
        # one codebook over the whole padded tensor and unit scales, as the
        # reference's code does (its comment there speaks of an amax
        # normalisation that the code does not do)
        cb = quant.kmeans_codebook(wt, bits)
        scales = torch.ones((wt.shape[0],), dtype=torch.float32, device=w.device)
        idx = quant.codebook_quantize(wt, cb)
        levels = cb.levels
    else:
        scales, idx = _codes(wt, bits, policy.signed, G)
        levels = quant.uniform_codebook(bits, policy.signed, device=w.device).levels
    a_levels, plut = _act_tables(policy, levels)
    a_sc = None
    if a_static is not None and a_levels is not None:
        a_sc = torch.tensor(a_static, dtype=torch.float32, device=w.device)
    scheme = policy.scheme
    if kern == "lut_gemm_bitsliced":
        # the plane decomposition is the codebook: code value = idx - 2^(b-1)
        packed, scheme = packing.pack_bitplanes_signed(idx, bits), "bs"
    elif scheme in ("c", "d"):
        packed = packing.pack_indexready(idx, bits)
    else:
        packed = packing.pack(idx, bits)
    return QuantizedWeight(
        packed=packed, codebook=levels, scales=scales, bits=bits,
        in_features=w.shape[0], out_features=w.shape[1], group_size=G,
        a_bits=policy.a_bits, scheme=scheme, kernel=kern,
        a_levels=a_levels, plut=plut, a_sc=a_sc, tp=tp_role,
        nonuniform=policy.nonuniform)


def _tp_op(qw: QuantizedWeight) -> tuple[str, tuple]:
    """The op ``dense_serve`` sends a role-stamped leaf to under TP, and
    the whole shapes of its operands (the activation's K, in the form the
    op takes it, then the leaf's own tensors; None for an empty slot)."""
    K, G = qw.k_padded, qw.group_size
    if qw.a_bits is None:
        return "dequant_matmul", ((1, K), qw.packed, qw.codebook, qw.scales)
    if qw.kernel == "lut_gemm_bitsliced":
        if qw.tp == "row":
            return "lut_gemm_bitsliced", ((1, K), qw.packed,
                                          qw.scales if G is not None else None)
        return "lut_gemm_bs_fused", ((1, K), qw.packed, qw.scales, None)
    return "lut_gemm", ((1, K // packing.PACK_FACTOR[qw.a_bits]), qw.packed,
                        qw.plut, qw.scales if G is not None else None)


def shard_weight(qw: QuantizedWeight, rank: int, world: int) -> QuantizedWeight:
    """Rank ``rank``'s slice of a role-stamped leaf for ``world`` ranks: the
    tensors its op's TP rule cuts (``packed``, and ``scales`` where the op
    takes them) keep the rank's N ('col') or K ('row') range; codebooks,
    tables and a static scale stay whole. A leaf whose rule does not divide
    stays whole on every rank and loses its role, as in the reference.
    Leaves without a role, and ``world`` 1, pass through."""
    if qw.tp is None or world == 1:
        return qw
    name, operands = _tp_op(qw)
    shapes = tuple(None if t is None else tuple(t.shape) if torch.is_tensor(t)
                   else t for t in operands)
    axes = kreg.tp_split(name, qw.tp, {"group_size": qw.group_size}, shapes,
                         world)
    if axes is None:
        return dataclasses.replace(qw, tp=None)
    cut = {}
    for ax, t in zip(axes[1:], operands[1:]):
        if ax is None or t is None:
            continue
        field = next(f for f in ("packed", "scales") if getattr(qw, f) is t)
        n = t.shape[ax] // world
        cut[field] = t.narrow(ax, rank * n, n).clone(
            memory_format=torch.contiguous_format)
    return dataclasses.replace(qw, tp_shards=world, **cut)


def quantize_expert_weight(w: torch.Tensor, policy: QuantPolicy) -> QuantizedWeight:
    """Offline quantize+pack of stacked expert weights: w (E, in, out) ->
    packed (E, out, in_pad/f) in the natural byte layout, scales (E, out)
    per expert and channel or (E, out, in_pad/G). A 'lut_gemm' plan keeps
    the LUT route (``a_bits``, the activation codebook and the product LUT
    on the leaf); every other plan, the bit-sliced ones included, leaves
    ``a_bits`` unset, and the MoE forward runs it through
    ``expert_dequant_matmul``. As in the reference, ``nonuniform`` is
    ignored here: expert leaves carry uniform levels."""
    bits = policy.w_bits
    if bits is None or w.ndim != 3:
        raise ValueError("quantize_expert_weight needs w_bits and an (E, in, "
                         f"out) weight, got {tuple(w.shape)}")
    G = policy.group_size
    wt = _pad_k(w.transpose(1, 2).to(torch.float32).contiguous(),
                _k_multiple(policy))                       # (E, out, in_pad)
    scales, idx = _codes(wt, bits, policy.signed, G)
    del wt
    levels = quant.uniform_codebook(bits, policy.signed, device=w.device).levels
    kern = policy.resolved_kernel() if policy.kernel else None
    a_levels, plut = _act_tables(policy, levels)
    return QuantizedWeight(
        packed=packing.pack(idx, bits), codebook=levels, scales=scales,
        bits=bits, in_features=w.shape[1], out_features=w.shape[2],
        group_size=G, a_bits=policy.a_bits if kern == "lut_gemm" else None,
        scheme=policy.scheme, kernel=kern, a_levels=a_levels, plut=plut)


def dequant_weight(qw: QuantizedWeight) -> torch.Tensor:
    """Full dequantization (codebook gather + per-channel or group scale),
    returned as (in, out), or (E, in, out) for an expert leaf."""
    w = qw.codebook[qw.unpacked_idx().long()]                    # (out, in_pad)
    if qw.group_size is not None:
        w = w * quant.expand_group_scales(qw.scales, qw.group_size)
    else:
        w = w * qw.scales[..., None]
    return w[..., : qw.in_features].transpose(-1, -2)


def dense_init(generator: torch.Generator, in_features: int, out_features: int,
               *, bias: bool = False, dtype=torch.float32, device=None) -> dict:
    """A plain dense layer {"w": (in, out)[, "b": (out,)]}: normal *
    in^-0.5 weights from ``generator`` (the reference's distribution, not
    its bits), zero bias."""
    w = torch.randn((in_features, out_features), generator=generator,
                    dtype=torch.float32, device=device) * (in_features ** -0.5)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((out_features,), dtype=dtype, device=device)
    return p


def dense_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (..., in) -> (..., out) in x's dtype: the plain mode of the
    reference's ``dense_apply`` (its QAT mode waits for the training slice,
    ROADMAP queue 1, item 10)."""
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def dense_serve(qw: QuantizedWeight, x: torch.Tensor, *,
                a_bits: Optional[int] = None,
                a_scale: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                backend: str = "auto") -> torch.Tensor:
    """Serving forward with packed weights. x: (..., in) -> (..., out), in
    x's dtype. Mirrors the reference's K padding (lcm of both pack
    factors), M padding (to a multiple of 8 above 8 rows) and activation
    scale rules (static leaf scale, else one dynamic scale per row).
    Bit-sliced leaves take the fused route: the raw rows go into
    ``lut_gemm_bs_fused`` with the scale (explicit, the leaf's static one,
    or None for the op's own per-row amax) in its fourth slot, except a
    row-parallel leaf under ``use_tp``: the fused op's row amax needs the
    whole K row, so the rows are quantized here, once, and the two-step
    ``lut_gemm_bitsliced`` runs on the rank's K slice (per channel
    bit-identical to the fused route: both sum the same exact integers and
    apply the same epilogue). The leaf's TP role reaches every dispatch."""
    tp_on = sharding.active_tp() is not None
    if qw.tp_shards > 1 and not tp_on:
        raise ValueError("a rank's slice of a tensor-parallel leaf runs only "
                         "under dist.sharding.use_tp")
    if a_bits is None and qw.kernel in ("lut_gemm", "lut_gemm_bitsliced"):
        a_bits = qw.a_bits
    lead = x.shape[:-1]
    xm = x.reshape(-1, qw.in_features)
    k_pad = qw.k_padded
    if k_pad != qw.in_features:
        xm = torch.nn.functional.pad(xm, (0, k_pad - qw.in_features))
    n_rows = xm.shape[0]
    if n_rows > 8 and n_rows % 8:
        xm = torch.nn.functional.pad(xm, (0, 0, 0, (-n_rows) % 8))
    G = qw.group_size
    if a_bits is None:
        y = kreg.dispatch("dequant_matmul", xm.contiguous(), qw.packed,
                          qw.codebook, qw.scales, bits=qw.bits, group_size=G,
                          backend=backend, tp=qw.tp)
    else:
        # static (calibrated offline) scale from the leaf, else dynamic: one
        # scale per row, so rows stay batch-composition-independent
        if a_scale is None and qw.a_sc is not None and a_bits == qw.a_bits:
            a_scale = qw.a_sc.reshape(1, 1).to(torch.float32)
        two_step = qw.kernel == "lut_gemm_bitsliced" and qw.tp == "row" and tp_on
        if qw.kernel == "lut_gemm_bitsliced" and not two_step:
            # the op quantizes the rows itself and applies every scale
            y = kreg.dispatch("lut_gemm_bs_fused", xm.contiguous(), qw.packed,
                              qw.scales, a_scale, w_bits=qw.bits,
                              a_bits=a_bits, group_size=G, backend=backend,
                              tp=qw.tp)
        else:
            if a_scale is None:
                a_scale, _ = quant.compute_scale_zero_point(xm, a_bits, signed=True,
                                                            axis=0)   # (M, 1)
            aq = quant.quantize(xm, a_scale, bits=a_bits, signed=True)
            if two_step:
                # int8 codes in, integer sums (or group-scaled partials) out,
                # summed over the ranks by the registry
                y = kreg.dispatch("lut_gemm_bitsliced",
                                  aq.to(torch.int8).contiguous(), qw.packed,
                                  qw.scales if G is not None else None,
                                  w_bits=qw.bits, a_bits=a_bits, group_size=G,
                                  backend=backend, tp=qw.tp)
            else:
                a_idx = quant.to_index(aq, a_bits, True)
                if qw.plut is not None and a_bits == qw.a_bits:
                    table = qw.plut
                else:
                    a_levels = quant.uniform_codebook(a_bits, True,
                                                      device=x.device).levels
                    table = product_lut(qw.codebook, a_levels).table
                y = kreg.dispatch("lut_gemm", packing.pack(a_idx, a_bits),
                                  qw.packed, table,
                                  qw.scales if G is not None else None,
                                  w_bits=qw.bits, a_bits=a_bits, group_size=G,
                                  float_table=qw.nonuniform, backend=backend,
                                  tp=qw.tp)
            y = y * a_scale if G is not None else y * qw.scales[None, :] * a_scale
    y = y[:n_rows]
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, qw.out_features).to(x.dtype)
