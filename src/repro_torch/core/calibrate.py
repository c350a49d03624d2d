"""Offline activation-range calibration for static activation scales (the
port's counterpart of ``repro/core/calibrate.py``).

A static scale takes the per-row amax reduction off the w{b}a{b} hot
path: a few sample batches run OFFLINE, each dense layer's input amax is
recorded, and ``amax / qmax`` is folded into the packed leaf
(``QuantizedWeight.a_sc``) when ``lm.quantize_tree`` packs it.

``models.layers.dense`` calls ``observe(tag, x)`` on every forward. Outside
a ``collect_act_stats()`` context that is a no-op. Inside it, each tag
("attn.wq", "mlp.w_down", ...) keeps one running-amax tensor on x's device,
folded with ``torch.maximum``, so no dense call waits for the host; the
stats are read once, when the context exits. One tag takes the max over
every layer that shares it: the tag granularity plans are written in.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_ACTIVE: Optional[dict] = None


@contextlib.contextmanager
def collect_act_stats():
    """Collect per-tag activation amax from every ``dense`` call made while
    the context is active. Yields a dict that holds, once the context has
    exited, each tag's amax as a float (a tag whose amax stayed 0 is left
    out, as the reference's callback never records it)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, {}
    stats: dict = {}
    try:
        yield stats
    finally:
        running, _ACTIVE = _ACTIVE, prev
        if running:
            tags = list(running)
            values = torch.stack([running[t] for t in tags]).tolist()
            stats.update({t: v for t, v in zip(tags, values) if v > 0.0})


def observe(tag: str, x: torch.Tensor) -> None:
    """Fold ``max |x|`` into ``tag``'s running amax while calibration is
    active; nothing otherwise."""
    if _ACTIVE is None:
        return
    amax = x.detach().float().abs().amax()
    prev = _ACTIVE.get(tag)
    _ACTIVE[tag] = amax if prev is None else torch.maximum(prev, amax)


def lookup(stats: Optional[dict], tag: str) -> Optional[float]:
    """The amax recorded for ``tag``: the calibration key is the
    layer-class suffix of the full tree path ('layers.0.attn.wq' ->
    'attn.wq'), so suffixes are tried longest first."""
    if not stats:
        return None
    parts = [p for p in tag.split(".") if p]
    for i in range(len(parts)):
        key = ".".join(parts[i:])
        if key in stats:
            return stats[key]
    return None


def static_scale(amax: float, a_bits: int) -> float:
    """Symmetric signed scale amax / qmax, the convention of the dynamic
    per-row path in ``qlinear.dense_serve``."""
    qmax = 2 ** (a_bits - 1) - 1
    return max(amax, 1e-8) / max(qmax, 1)
