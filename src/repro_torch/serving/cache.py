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

Differences from the reference: the forward scatters into these tensors in
place (the reference donates and returns new pools); and an unquantized
pool takes the model's dtype, where the reference always allocates bf16
(with an f32 model its scatter then refuses the f32 rows).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models import layers as L, lm

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


def init_paged_cache(cfg, n_blocks: int, block_size: int, dtype,
                     device) -> list:
    """One pool dict per layer (global attention layers only), laid out by
    ``lm._layer_cache``."""
    return [lm._layer_cache(cfg, n_blocks, block_size, dtype, device)
            for _ in range(cfg.n_layers)]


def write_prompt_rows(caches: list, rows: list, blocks: list,
                      block_size: int, kv_dtype: str) -> None:
    """In place: a whole-prompt forward's per-layer K/V (``forward(...,
    collect_cache=True)``: (1, P, KV, hd), post-RoPE, unquantized) into the
    slot's ``blocks``, quantized per token for an int8 or int4 pool. Rows
    past P in the last block are zeros (their scales too); attention masks
    them."""
    for pool, kv in zip(caches, rows):
        parts = {"k": kv["k"][0], "v": kv["v"][0]}
        if kv_dtype in L.KV_QUANT:
            qf = L.KV_QUANT[kv_dtype][0]
            (k, k_sc), (v, v_sc) = qf(kv["k"]), qf(kv["v"])
            parts = {"k": k[0], "v": v[0], "k_sc": k_sc[0], "v_sc": v_sc[0]}
        P = parts["k"].shape[0]
        nfb = -(-P // block_size)
        ids = torch.as_tensor(blocks[:nfb], dtype=torch.int64,
                              device=parts["k"].device)
        for name, val in parts.items():
            pad = [0, 0] * (val.ndim - 1) + [0, nfb * block_size - P]
            val = torch.nn.functional.pad(val, pad).to(pool[name].dtype)
            pool[name][ids] = val.reshape(nfb, block_size, *val.shape[1:])
