"""Carry the JAX reference's parameter trees across to the port.

Both functions take the reference's tree with its arrays already turned
into numpy (``jax.tree.map(np.asarray, tree)``), so this module needs
neither ``jax`` nor ``repro``:

  params_from_jax   a plain tree from ``repro.models.lm.init_params``
  qparams_from_jax  a tree packed by ``repro.models.lm.quantize_tree``,
                    whose ``QuantizedWeight`` leaves arrive as objects with
                    the same field names (numpy arrays + aux ints/strings);
                    bit-plane leaves (scheme 'bs') keep their
                    (bits, N, K/4) planes, and ``a_sc`` comes along where set

The reference stacks the superblock scan axis first (``blocks``: every
array carries a leading ``n_superblocks`` axis, one entry per repeat of the
layer pattern) and keeps remainder layers under ``rem``; the port keeps a
flat ``layers`` list, in forward order (all superblocks, then the
remainder). bfloat16 arrays (numpy dtype named 'bfloat16') are carried
bit for bit through a 16-bit integer view.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qlinear import QuantizedWeight

_QW_ARRAYS = ("packed", "codebook", "scales", "a_levels", "plut", "a_sc")


def to_torch(x, device) -> torch.Tensor:
    """numpy array (bfloat16 included) -> tensor on ``device``, bit exact."""
    a = np.array(x, copy=True, order="C")       # writable, contiguous
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _is_qw(x) -> bool:
    return hasattr(x, "packed") and hasattr(x, "codebook") and hasattr(x, "scales")


def _qw_from(leaf, index, device) -> QuantizedWeight:
    if getattr(leaf, "tp", None) is not None:
        route = ""
        if getattr(leaf, "scheme", "a") == "bs":
            route = (" (a row-parallel bit-sliced leaf takes the two-step "
                     "lut_gemm_bitsliced route)")
        raise NotImplementedError(f"tensor-parallel packed leaves{route} are "
                                  "not ported yet: ROADMAP queue 1, item 11")
    arrays = {}
    for name in _QW_ARRAYS:
        v = getattr(leaf, name)
        if v is not None:
            v = np.asarray(v)
            arrays[name] = to_torch(v[index] if index is not None else v, device)
        else:
            arrays[name] = None
    return QuantizedWeight(
        bits=int(leaf.bits), in_features=int(leaf.in_features),
        out_features=int(leaf.out_features), group_size=leaf.group_size,
        a_bits=leaf.a_bits, scheme=leaf.scheme, kernel=leaf.kernel, **arrays)


def _convert(tree, index, device):
    """Slice ``index`` off the leading stack axis (None: unstacked) and
    convert every leaf."""
    if _is_qw(tree):
        return _qw_from(tree, index, device)
    if isinstance(tree, dict):
        return {k: _convert(v, index, device) for k, v in tree.items()}
    a = np.asarray(tree)
    return to_torch(a[index] if index is not None else a, device)


def _layers(np_tree: dict, cfg, device) -> list:
    layers = []
    pattern = cfg.pattern
    if "blocks" in np_tree:
        blocks = np_tree["blocks"]
        n_sb = cfg.n_layers // len(pattern)
        for s in range(n_sb):
            for j in range(len(pattern)):
                layers.append(_convert(blocks[f"l{j}"], s, device))
    for i in range(cfg.n_remainder):
        layers.append(_convert(np_tree["rem"][f"r{i}"], None, device))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config says "
                         f"{cfg.n_layers}")
    return layers


def params_from_jax(np_tree: dict, cfg, device="cpu") -> dict:
    """The reference's plain parameter tree (numpy leaves) -> the port's."""
    return {"tok_embed": to_torch(np_tree["tok_embed"], device),
            "final_norm": _convert(np_tree["final_norm"], None, device),
            "layers": _layers(np_tree, cfg, device)}


def qparams_from_jax(np_tree: dict, cfg, device="cpu") -> dict:
    """The reference's quantize_tree'd tree (numpy leaves; packed leaves
    stacked over superblocks) -> the port's packed parameter dict."""
    return params_from_jax(np_tree, cfg, device)
