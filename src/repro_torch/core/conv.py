"""Convolution as im2col + LUT GEMM: the paper's CNN operators (§5.1/5.2),
the port's counterpart of ``repro/core/conv.py``.

An NHWC convolution is lowered to patches (N*OH*OW, C*KH*KW) @ a filter
matrix (C*KH*KW, Cout), either in plain torch (``conv2d_apply``) or
through the packed LUT serving path (``conv2d_serve``: quantize and pack
the patches, ``lut_gemm``, the scales in the epilogue). The patch
features are ordered channel first, c*KH*KW + i*KW + j: the order of the
reference's ``conv_general_dilated_patches`` (its comment there names
another order; the code's order is the one kept).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import qlinear
from .qlinear import QuantizedWeight


def _out_size(size: int, k: int, stride: int, padding: str) -> tuple[int, int, int]:
    """(output size, pad before, pad after) along one spatial axis. SAME
    pads ph // 2 before and the rest after (asymmetric for an even pad)."""
    if padding == "SAME":
        out = -(-size // stride)
        pad = max((out - 1) * stride + k - size, 0)
        return out, pad // 2, pad - pad // 2
    return (size - k) // stride + 1, 0, 0


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME") -> tuple[torch.Tensor, tuple[int, int]]:
    """x: (N, H, W, C) -> patches (N*OH*OW, C*KH*KW), and (OH, OW)."""
    n, h, w, c = x.shape
    oh, ph0, ph1 = _out_size(h, kh, stride, padding)
    ow, pw0, pw1 = _out_size(w, kw, stride, padding)
    x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))          # F.unfold pads symmetrically
    cols = F.unfold(x.permute(0, 3, 1, 2), (kh, kw), stride=stride)  # (N, C*KH*KW, L)
    return cols.transpose(1, 2).reshape(n * oh * ow, c * kh * kw), (oh, ow)


def conv_gemm_shape(x_shape, kh: int, kw: int, cout: int, stride: int = 1):
    """The im2col GEMM of a SAME conv layer in the labels of the paper's
    Fig. 5, (M, N, K): N*OH*OW patch rows, KH*KW*C features, Cout
    filters."""
    n, h, w, c = x_shape
    oh, ow = -(-h // stride), -(-w // stride)
    return (n * oh * ow, kh * kw * c, cout)


def conv2d_init(generator: torch.Generator, kh: int, kw: int, cin: int, cout: int,
                dtype=torch.float32, device=None) -> dict:
    """{"w": (KH*KW*Cin, Cout) normal / sqrt(fan_in) from ``generator``,
    "kh", "kw", "cin", "cout"}: the reference's distribution, not its
    bits."""
    fan_in = kh * kw * cin
    w = torch.randn((fan_in, cout), generator=generator, dtype=torch.float32,
                    device=device) / math.sqrt(fan_in)
    return {"w": w.to(dtype), "kh": kh, "kw": kw, "cin": cin, "cout": cout}


def conv2d_apply(params: dict, x: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """The plain conv through its im2col GEMM: (N, H, W, Cin) -> (N, OH,
    OW, Cout) (the reference's QAT mode waits for the training slice)."""
    patches, (oh, ow) = im2col(x, params["kh"], params["kw"], stride)
    y = qlinear.dense_apply({k: v for k, v in params.items() if k in ("w", "b")},
                            patches)
    return y.reshape(x.shape[0], oh, ow, params["cout"])


def conv2d_serve(qw: QuantizedWeight, x: torch.Tensor, kh: int, kw: int, *,
                 stride: int = 1, a_bits: Optional[int] = 2,
                 backend: str = "auto") -> torch.Tensor:
    """The packed LUT conv (the paper's deployed operator): im2col, then
    ``dense_serve`` (per-row activation quantization and packing,
    ``lut_gemm``, the scales) -> (N, OH, OW, Cout)."""
    patches, (oh, ow) = im2col(x, kh, kw, stride)
    y = qlinear.dense_serve(qw, patches, a_bits=a_bits, backend=backend)
    return y.reshape(x.shape[0], oh, ow, qw.out_features)
