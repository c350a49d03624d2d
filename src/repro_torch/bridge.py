"""Carry the JAX reference's parameter trees and decode caches across to
the port.

Every function takes the reference's tree with its arrays already turned
into numpy (``jax.tree.map(np.asarray, tree)``), so this module needs
neither ``jax`` nor ``repro``:

  params_from_jax   a plain tree from ``repro.models.lm.init_params``
  qparams_from_jax  a tree packed by ``repro.models.lm.quantize_tree``,
                    whose ``QuantizedWeight`` leaves arrive as objects with
                    the same field names (numpy arrays + aux ints/strings);
                    bit-plane leaves (scheme 'bs') keep their
                    (bits, N, K/4) planes, and ``a_sc`` comes along where set;
                    a tree packed with ``quantize_tree(..., tp=N)`` keeps
                    each leaf's role, and with ``tp_size`` N the function
                    keeps rank ``tp_rank``'s slice of every role-stamped
                    leaf (``qlinear.shard_weight``: ``packed`` along N for
                    'col' or along the packed K axis for 'row', group
                    scales by the same rule, per-channel scales along N
                    where the leaf's op takes them; codebooks, tables and
                    ``a_sc`` whole); expert leaves with a role are refused
                    (ROADMAP queue 1, item 11);
                    an MoE layer's expert leaves arrive stacked as
                    (n_superblocks, E, N, K/f) and leave as (E, N, K/f), its
                    f32 router and shared expert like any other array / dense
                    leaf
                    k-means leaves keep their float ``codebook`` and
                    ``plut`` (and come out ``nonuniform``), and legacy
                    leaves their ``kernel`` None; a recurrent layer's
                    ``rnn`` / ``rwkv`` subtree comes along like any other
                    (float leaves as tensors, dense leaves as above)
  qweight_from_jax  one ``QuantizedWeight`` of ``repro.core.qlinear.
                    quantize_weight`` (a conv layer's, say)
  conv_params_from_jax  a conv layer's params from ``repro.core.conv.
                    conv2d_init`` ({"w": (fan_in, cout), "kh", "kw", "cin",
                    "cout"}; the ints arrive as 0-d arrays and leave as ints)
  cache_from_jax    the fixed-batch loop's dense decode cache from
                    ``repro.models.lm.init_cache`` or ``prefill_to_cache``
                    ({"blocks": {"l<j>": {"attn": {k, v[, k_sc, v_sc]}}},
                    "rem": {"r<i>": ...}}, the blocks stacked over
                    superblocks) -> the port's flat list with one
                    {k, v[, k_sc, v_sc]} dict per attention layer and the
                    per-sequence state of a recurrent one ({"rnn": {h,
                    conv}} or {"rwkv": {s, shift_t, shift_c}})

The reference stacks the superblock scan axis first (``blocks``: every
array carries a leading ``n_superblocks`` axis, one entry per repeat of the
layer pattern) and keeps remainder layers under ``rem``; the port keeps a
flat ``layers`` list, in forward order (all superblocks, then the
remainder), each layer's type being ``cfg.layer_type(i)``, as the
reference's superblocks and their pattern prefix give it. bfloat16 arrays (numpy dtype named 'bfloat16') are carried
bit for bit through a 16-bit integer view.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qlinear import QuantizedWeight, shard_weight

_QW_ARRAYS = ("packed", "codebook", "scales", "a_levels", "plut", "a_sc")
_EXPERT_LEAVES = {"we_gate", "we_up", "we_down"}


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


def _qw_from(leaf, index, device, tp_rank: int = 0,
             tp_size: int = 1) -> QuantizedWeight:
    arrays = {}
    for name in _QW_ARRAYS:
        v = getattr(leaf, name)
        if v is not None:
            v = np.asarray(v)
            arrays[name] = to_torch(v[index] if index is not None else v, device)
        else:
            arrays[name] = None
    # the reference's leaf does not say whether its codebook is k-means:
    # its levels do (a uniform codebook's are integers), read here on the
    # host as the leaf is converted
    cb = np.asarray(leaf.codebook)
    qw = QuantizedWeight(
        bits=int(leaf.bits), in_features=int(leaf.in_features),
        out_features=int(leaf.out_features), group_size=leaf.group_size,
        a_bits=leaf.a_bits, scheme=leaf.scheme, kernel=leaf.kernel,
        tp=getattr(leaf, "tp", None), nonuniform=bool((cb != np.round(cb)).any()),
        **arrays)
    return shard_weight(qw, tp_rank, tp_size)


def _convert(tree, index, device, tp_rank: int = 0, tp_size: int = 1):
    """Slice ``index`` off the leading stack axis (None: unstacked) and
    convert every leaf, keeping rank ``tp_rank``'s slice of role-stamped
    packed leaves."""
    if _is_qw(tree):
        return _qw_from(tree, index, device, tp_rank, tp_size)
    if isinstance(tree, dict):
        for k in _EXPERT_LEAVES.intersection(tree):
            if getattr(tree[k], "tp", None) is not None:
                raise NotImplementedError(
                    f"{k}: tensor-parallel expert leaves are not ported yet: "
                    "ROADMAP queue 1, item 11")
        return {k: _convert(v, index, device, tp_rank, tp_size)
                for k, v in tree.items()}
    a = np.asarray(tree)
    return to_torch(a[index] if index is not None else a, device)


def _layers(np_tree: dict, cfg, device, tp_rank: int = 0, tp_size: int = 1) -> list:
    layers = []
    pattern = cfg.pattern
    if "blocks" in np_tree:
        blocks = np_tree["blocks"]
        n_sb = cfg.n_layers // len(pattern)
        for s in range(n_sb):
            for j in range(len(pattern)):
                layers.append(_convert(blocks[f"l{j}"], s, device, tp_rank,
                                       tp_size))
    for i in range(cfg.n_remainder):
        layers.append(_convert(np_tree["rem"][f"r{i}"], None, device, tp_rank,
                               tp_size))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config says "
                         f"{cfg.n_layers}")
    return layers


def params_from_jax(np_tree: dict, cfg, *, device, tp_rank: int = 0,
                    tp_size: int = 1) -> dict:
    """The reference's plain parameter tree (numpy leaves) -> the port's
    on ``device``: the tied ``tok_embed``, or ``in_embed`` and the untied
    ``lm_head``."""
    out = {name: to_torch(np_tree[name], device)
           for name in ("tok_embed", "in_embed") if name in np_tree}
    if "lm_head" in np_tree:
        out["lm_head"] = _convert(np_tree["lm_head"], None, device, tp_rank,
                                  tp_size)
    out["final_norm"] = _convert(np_tree["final_norm"], None, device)
    out["layers"] = _layers(np_tree, cfg, device, tp_rank, tp_size)
    return out


def qparams_from_jax(np_tree: dict, cfg, *, device, tp_rank: int = 0,
                     tp_size: int = 1) -> dict:
    """The reference's quantize_tree'd tree (numpy leaves; packed leaves
    stacked over superblocks) -> the port's packed parameter dict on
    ``device``; with ``tp_size`` > 1, rank ``tp_rank``'s slice of it."""
    return params_from_jax(np_tree, cfg, device=device, tp_rank=tp_rank,
                           tp_size=tp_size)


def qweight_from_jax(leaf, *, device) -> QuantizedWeight:
    """One reference ``QuantizedWeight`` (numpy arrays) -> the port's."""
    return _qw_from(leaf, None, device)


_CONV_INTS = ("kh", "kw", "cin", "cout")


def conv_params_from_jax(np_tree: dict, *, device) -> dict:
    """A reference conv layer's params (numpy leaves) -> the port's: the
    filter matrix (and bias) bit for bit, the shape fields as ints."""
    return {k: int(v) if k in _CONV_INTS else to_torch(v, device)
            for k, v in np_tree.items()}


def cache_from_jax(np_tree: dict, cfg, *, device) -> list:
    """The reference's dense decode cache (numpy leaves) -> the port's
    per-layer list, in forward order, bit for bit (int8 / u8 codes, f32
    scales, or k/v in the model dtype; a recurrent layer's state as it
    is)."""
    return [layer["attn"] if "attn" in layer else layer
            for layer in _layers(np_tree, cfg, device)]
