"""The paper's CNN (``configs/deepgemm_cnn.py``) as a stack of 3x3 convs
at stride 1: the stem, then each stage's convs, ReLU after each, a global
mean over H and W at the end (the reference's
``examples/cnn_paper_repro.py``). Every conv runs as an im2col GEMM
(core/conv.py): plain, or packed through ``lut_gemm``."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import conv, qlinear
from repro_torch.device import resolve_device


def channels(cfg) -> list[int]:
    """Each conv's output channels: the stem's, then every stage's."""
    return [cout for cout, n in ((cfg.stem[0], 1),) + tuple(cfg.stages)
            for _ in range(n)]


def init_params(cfg, generator: torch.Generator, device="cuda") -> list[dict]:
    """One ``conv.conv2d_init`` dict per conv, 3x3, from ``generator``
    (which must live on ``device``), in forward order."""
    dev = resolve_device(device)
    params, cin = [], cfg.in_ch
    for cout in channels(cfg):
        params.append(conv.conv2d_init(generator, 3, 3, cin, cout, device=dev))
        cin = cout
    return params


def quantize(params: list[dict], policy: qlinear.QuantPolicy) -> list:
    """Each conv's filter matrix packed under ``policy`` (offline)."""
    return [qlinear.quantize_weight(p["w"], policy) for p in params]


def forward_plain(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, Cout) features through the plain convs."""
    for p in params:
        x = torch.relu(conv.conv2d_apply(p, x))
    return x.mean((1, 2))


def forward_lut(qws: list, x: torch.Tensor, *, a_bits: int,
                backend: str = "auto") -> torch.Tensor:
    """(N, H, W, C) -> (N, Cout) features through the packed convs: each
    an im2col ``lut_gemm`` on ``a_bits``-bit activation codes."""
    for qw in qws:
        x = torch.relu(conv.conv2d_serve(qw, x, 3, 3, a_bits=a_bits, backend=backend))
    return x.mean((1, 2))


def reduce_for_smoke(cfg):
    """The same stack at CPU size: widths 8 and 16, 8x8 images."""
    return dataclasses.replace(cfg, stem=(8, 3, 3, 1), stages=((8, 2), (16, 2)),
                               img_hw=8)
