"""Paged KV-cache block pool for the port's serving engine.

The port's counterpart of ``repro/serving/cache.py``: the host-side
refcounting ``BlockPool`` allocator, ``table_row``, the per-layer pool
tensors of attention layers, and ``write_prompt_rows``, which scatters a
whole-prompt forward's K/V into a slot's blocks. A block's refcount is its
number of owners: the slots whose tables hold it, plus the radix tree
(serving/radix.py) when it indexes the block. The speculative drafter's
pool is a second tree of the same layout, addressed by the same block ids.

Layout per attention layer (``n_blocks`` blocks of ``block_size`` rows):

  unquantized : k, v        (n_blocks, block_size, KV, hd) in the model dtype
  int8        : k, v int8   (n_blocks, block_size, KV, hd) + k_sc/v_sc f32
                (n_blocks, block_size, KV)
  int4        : k, v uint8  (n_blocks, block_size, KV, hd/2), two 4-bit
                codes per byte (low nibble first) + k_sc/v_sc f32

Physical block 0 is the NULL block: free table entries point at it, writes
from inactive decode rows and pad rows land there, and its contents are
always masked out in attention.

Ring-paged local layers (``Engine(ring=True)``; the reference's
cache.py:146-196 and :359-401): ``init_paged_cache(..., ring_blocks=N)``
gives every local layer's tensors N blocks instead of ``n_blocks``. They
form a second id space with its own null block, which the engine's second
``BlockPool`` allocates: a slot owns a ring of ``ring_len`` blocks, and
absolute row t lives in its ring block (t // block_size) % ring_len at
offset t % block_size (``ring_abs_row`` spells the ring out as a table of
absolute block entries). ``write_prompt_rows`` scatters a whole prompt's
last min(P, ring rows) rows of a local layer into its ring.

Recurrent layers (RG-LRU, RWKV6) hold no block: their O(1) state stays
per slot, a leading ``n_slots`` axis, as in ``lm.init_cache`` ({"rnn": ...}
or {"rwkv": ...}; the reference's cache.py:64 and :227-306). A model with
no attention layer (rwkv6) holds no device pool at all, while the engine
keeps its block bookkeeping as the reference's does. ``slot_view`` narrows
the states to one slot for a prefill chunk or a whole prompt (views, so
the forward's in-place update, or ``write_prompt_rows``'s, lands in the
slot), and ``reset_slot`` zeroes a slot's state at admission.
A decode step keeps the state of idle and prefilling slots through the
forward's ``active`` mask (the reference's ``select_slots``).

Differences from the reference: the forward scatters into these tensors in
place (the reference donates and returns new pools); and an unquantized
pool takes the model's dtype, where the reference always allocates bf16
(with an f32 model its scatter then refuses the f32 rows). The states'
conv and shift rows stay bf16 as the reference's do (a prefill chunk's
new rows round to bf16 even under an f32 model).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import STATE_TYPES
from repro_torch.models import layers as L, lm
from repro_torch.models import recurrent as R

NULL_BLOCK = 0


def table_row(blocks: list, width: int) -> np.ndarray:
    """One NULL-padded block-table row: entry j is the physical block
    holding token rows [j*block_size, (j+1)*block_size)."""
    row = np.full((width,), NULL_BLOCK, np.int64)
    row[: len(blocks)] = blocks
    return row


class BlockPool:
    """Host-side refcounting allocator over physical block ids. Block 0 is
    the null block and never handed out; ``alloc`` is all-or-nothing and
    hands out blocks at refcount 1; ``ref`` adds an owner to a live block
    (a shared prefix); ``free`` drops one owner and a block rejoins the
    free list at refcount 0; a double free, or a ``ref`` of a free block,
    raises."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("pool needs >= 1 allocatable block + null block")
        self.n_blocks = n_blocks
        self._free: deque[int] = deque(range(1, n_blocks))
        self._refs = [0] * n_blocks

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        """Current owner count of ``block`` (0: free)."""
        return self._refs[block]

    def alloc(self, n: int) -> Optional[list[int]]:
        if n > len(self._free):
            return None
        ids = [self._free.popleft() for _ in range(n)]
        for b in ids:
            self._refs[b] = 1
        return ids

    def ref(self, ids: list[int]) -> None:
        """Add one owner to each live block."""
        for b in ids:
            if self._refs[b] <= 0:
                raise RuntimeError(f"ref on unallocated block {b}")
            self._refs[b] += 1

    def free(self, ids: list[int]) -> None:
        for b in ids:
            if self._refs[b] <= 0:
                raise RuntimeError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)


def ring_abs_row(ring: list, width: int) -> np.ndarray:
    """A ring as a table row of ``width`` absolute entries: entry j is the
    ring block (j % len(ring)) that holds rows [j*block_size,
    (j+1)*block_size) while they are live; all NULL for no ring. The
    decode attention ops read it as a plain block table."""
    if not ring:
        return np.full((width,), NULL_BLOCK, np.int64)
    return np.asarray(ring, np.int64)[np.arange(width) % len(ring)]


_PER_SLOT_KEYS = ("rnn", "rwkv")


def init_paged_cache(cfg, n_blocks: int, block_size: int, dtype, device,
                     ring_blocks: Optional[int] = None, n_slots: int = 1) -> list:
    """One dict per layer: an attention layer's pool, laid out by
    ``lm._layer_cache`` (a global layer's of ``n_blocks`` blocks, a local
    layer's of ``ring_blocks`` where given (ring-paged), else
    ``n_blocks``); a recurrent layer's zero state for ``n_slots`` slots,
    its conv and shift rows in bf16 as the reference's engine holds them
    (h and the WKV state f32)."""
    return [R.state_init(cfg, t, n_slots, torch.bfloat16, device)
            if t in STATE_TYPES
            else lm._layer_cache(cfg, ring_blocks if ring_blocks and t == "local"
                                 else n_blocks, block_size, dtype, device)
            for t in cfg.layer_types()]


def _states(layer: dict):
    """A layer's per-slot state tensors, by (key, name)."""
    return [(k, name, t) for k in _PER_SLOT_KEYS if k in layer
            for name, t in layer[k].items()]


def slot_view(caches: list, slot: int) -> list:
    """The tree with every per-slot state narrowed to ``slot`` (batch 1,
    views: an in-place update writes the slot's rows); pools pass through
    whole."""
    out = []
    for layer in caches:
        if any(k in layer for k in _PER_SLOT_KEYS):
            layer = {k: {n: t[slot:slot + 1] for n, t in v.items()}
                     for k, v in layer.items()}
        out.append(layer)
    return out


def reset_slot(caches: list, slot: int) -> None:
    """In place: zero ``slot``'s recurrent state (a newly admitted
    request's fresh state). No-op for attention-only models."""
    for layer in caches:
        for _, _, t in _states(layer):
            t[slot].zero_()


def _quantized_parts(k: torch.Tensor, v: torch.Tensor, kv_dtype: str) -> dict:
    """K/V rows (R, KV, hd) as the pool stores them: quantized per token
    for an int8 or int4 pool (with their f32 scales), else as they are."""
    if kv_dtype not in L.KV_QUANT:
        return {"k": k, "v": v}
    qf = L.KV_QUANT[kv_dtype][0]
    (kq, k_sc), (vq, v_sc) = qf(k[None]), qf(v[None])
    return {"k": kq[0], "v": vq[0], "k_sc": k_sc[0], "v_sc": v_sc[0]}


def write_prompt_rows(caches: list, rows: list, blocks: list,
                      block_size: int, kv_dtype: str, layer_types=None,
                      ring: Optional[list] = None) -> None:
    """In place: a whole-prompt forward's per-layer K/V (``forward(...,
    collect_cache=True)``: (1, P, KV, hd), post-RoPE, unquantized) into the
    slot's ``blocks``, quantized per token for an int8 or int4 pool. Rows
    past P in the last block are zeros (their scales too); attention masks
    them. With a ``ring`` (the slot's ring blocks), the local layers of
    ``layer_types`` take only the last min(P, R) rows, R = len(ring) *
    block_size, each at its ring row t % R (the reference's
    ``_scatter_ring_rows``): older rows lie outside every later query's
    window, and only real rows are written. A recurrent layer's entry,
    the prompt's final state (batch 1), lands in the states' first row:
    pass ``slot_view(caches, slot)``."""
    for i, (pool, kv) in enumerate(zip(caches, rows)):
        if any(k in pool for k in _PER_SLOT_KEYS):
            for key, name, t in _states(pool):
                t[0] = kv[key][name][0].to(t.dtype)
            continue
        if ring is not None and layer_types[i] == "local":
            P = kv["k"].shape[1]
            n = min(P, len(ring) * block_size)
            parts = _quantized_parts(kv["k"][0, P - n:], kv["v"][0, P - n:], kv_dtype)
            t = torch.arange(P - n, P, device=parts["k"].device)
            ring_t = torch.as_tensor(ring, dtype=torch.int64, device=t.device)
            blk, offs = ring_t[(t // block_size) % len(ring)], t % block_size
            for name, val in parts.items():
                pool[name][blk, offs] = val.to(pool[name].dtype)
            continue
        parts = _quantized_parts(kv["k"][0], kv["v"][0], kv_dtype)
        P = parts["k"].shape[0]
        nfb = -(-P // block_size)
        ids = torch.as_tensor(blocks[:nfb], dtype=torch.int64,
                              device=parts["k"].device)
        for name, val in parts.items():
            pad = [0, 0] * (val.ndim - 1) + [0, nfb * block_size - P]
            val = torch.nn.functional.pad(val, pad).to(pool[name].dtype)
            pool[name][ids] = val.reshape(nfb, block_size, *val.shape[1:])
