"""Packed serving weights and the planned dense forward (``dense_serve``).

The port's counterpart of ``repro/core/qlinear.py`` for serving:
``QuantPolicy`` (per-layer-class quantization), ``QuantizedWeight`` (packed
codes + codebook + scales + the offline activation codebook and product
LUT), ``quantize_weight`` / ``dequant_weight``, and ``dense_serve``, which
routes a planned leaf to its kernel op:

  w{b}a16   -> ``dequant_matmul`` (codebook dequant + matmul + scale)
  w{b}a{b}  -> per-row dynamic activation quantization (or the leaf's static
               scale), packed activation codes, ``lut_gemm``
  w{b}a8_bs -> ``lut_gemm_bs_fused`` on the raw activations: the op itself
               quantizes each row, runs the bit-plane core and applies
               every scale (bit-plane leaves, scheme 'bs')

One difference from the reference: under the 'ref' backend the reference
runs the w{b}a{b} route as a dequant dot (the GSPMD-shardable form); the
port always dispatches ``lut_gemm`` and its 'ref' backend is the plain LUT
sum. Both sum the same exact integer products per channel.

Not ported yet, and raising: k-means codebooks, QAT, and tensor-parallel
roles and autotuned tiles. The reference's two-step bit-sliced route
(``lut_gemm_bitsliced``) serves only row-parallel leaves under a TP mesh;
it comes with the TP slice (ROADMAP queue 1, item 11), and ``bridge.py``
refuses such leaves.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch

from . import packing, quant
from .lut import product_lut
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
    the layer to full precision. The reference's legacy use of a single
    policy as the whole config (with its ``skip`` list) is not ported."""
    w_bits: Optional[int] = 2
    a_bits: Optional[int] = None
    signed: bool = True
    scheme: str = "d"
    nonuniform: bool = False
    group_size: Optional[int] = None
    kernel: Optional[str] = None
    a_scale: str = "dynamic"

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
    'bs') hold (bits, out, in_pad/4) planes in ``packed`` and no ``plut``."""
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

    @property
    def k_padded(self) -> int:
        if self.scheme == "bs":
            return self.packed.shape[-1] * packing.BITPLANE_GROUP
        return self.packed.shape[-1] * packing.PACK_FACTOR[self.bits]

    def unpacked_idx(self) -> torch.Tensor:
        if self.scheme == "bs":
            return packing.unpack_bitplanes_signed(self.packed, self.bits)
        return packing.unpack(self.packed, self.bits)


def _k_multiple(policy: QuantPolicy) -> int:
    """Contraction-axis padding unit: the pack factor (or the scale group,
    itself a pack-factor multiple), lcm'd with the activation pack factor
    for w{b}a{b} LUT plans so both operands hold whole packed bytes, and
    with the plane group for the bit-sliced kernel (its activations stay
    unpacked)."""
    m = policy.group_size if policy.group_size is not None \
        else packing.PACK_FACTOR[policy.w_bits]
    kern = policy.resolved_kernel()
    if policy.a_bits is not None and kern == "lut_gemm":
        m = math.lcm(m, packing.PACK_FACTOR[policy.a_bits])
    if kern == "lut_gemm_bitsliced":
        m = math.lcm(m, packing.BITPLANE_GROUP)
    return m


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


def quantize_weight(w: torch.Tensor, policy: QuantPolicy, *,
                    a_static: Optional[float] = None) -> QuantizedWeight:
    """Offline quantize+pack of one dense weight: w (in, out) -> packed
    (out, in_pad/f), or (bits, out, in_pad/4) bit planes for the bit-sliced
    kernel, on w's device."""
    bits = policy.w_bits
    if bits is None:
        raise ValueError("quantize_weight needs a policy with w_bits set")
    if policy.nonuniform:
        raise NotImplementedError("k-means (non-uniform) codebooks are not "
                                  "ported yet: ROADMAP queue 1, item 2")
    kern = policy.resolved_kernel() if policy.kernel else None
    if kern == "lut_gemm_bitsliced" and not (policy.signed
                                             and policy.a_bits is not None):
        raise ValueError("bit-sliced route needs signed uniform w{b}a{b} "
                         "quantization")
    G = policy.group_size
    wt = _pad_k(w.T.to(torch.float32).contiguous(), _k_multiple(policy))  # (out, in_pad)
    if G is None:
        scales = quant.group_scales(wt, bits, None, signed=policy.signed)
        sfull = scales[..., None]
    else:
        scales = quant.group_scales(wt, bits, G, signed=policy.signed)
        sfull = quant.expand_group_scales(scales, G)
    q = quant.quantize(wt, sfull, bits=bits, signed=policy.signed)
    idx = quant.to_index(q, bits, policy.signed)
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
        a_levels=a_levels, plut=plut, a_sc=a_sc)


def dequant_weight(qw: QuantizedWeight) -> torch.Tensor:
    """Full dequantization (codebook gather + per-channel or group scale),
    returned as (in, out)."""
    w = qw.codebook[qw.unpacked_idx().long()]                    # (out, in_pad)
    if qw.group_size is not None:
        w = w * quant.expand_group_scales(qw.scales, qw.group_size)
    else:
        w = w * qw.scales[..., None]
    return w[..., : qw.in_features].transpose(-1, -2)


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
    or None for the op's own per-row amax) in its fourth slot."""
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
                          backend=backend)
    else:
        # static (calibrated offline) scale from the leaf, else dynamic: one
        # scale per row, so rows stay batch-composition-independent
        if a_scale is None and qw.a_sc is not None and a_bits == qw.a_bits:
            a_scale = qw.a_sc.reshape(1, 1).to(torch.float32)
        if qw.kernel == "lut_gemm_bitsliced":
            # the op quantizes the rows itself and applies every scale
            y = kreg.dispatch("lut_gemm_bs_fused", xm.contiguous(), qw.packed,
                              qw.scales, a_scale, w_bits=qw.bits,
                              a_bits=a_bits, group_size=G, backend=backend)
        else:
            if a_scale is None:
                a_scale, _ = quant.compute_scale_zero_point(xm, a_bits, signed=True,
                                                            axis=0)   # (M, 1)
            aq = quant.quantize(xm, a_scale, bits=a_bits, signed=True)
            a_idx = quant.to_index(aq, a_bits, True)
            if qw.plut is not None and a_bits == qw.a_bits:
                table = qw.plut
            else:
                a_levels = quant.uniform_codebook(a_bits, True, device=x.device).levels
                table = product_lut(qw.codebook, a_levels).table
            y = kreg.dispatch("lut_gemm", packing.pack(a_idx, a_bits), qw.packed,
                              table, qw.scales if G is not None else None,
                              w_bits=qw.bits, a_bits=a_bits, group_size=G,
                              backend=backend)
            y = y * a_scale if G is not None else y * qw.scales[None, :] * a_scale
    y = y[:n_rows]
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, qw.out_features).to(x.dtype)
