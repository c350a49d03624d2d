"""Paged KV-cache block pool for the port's serving engine.

The port's counterpart of ``repro/serving/cache.py``: the host-side
refcounting ``BlockPool`` allocator, ``table_row``, and the per-layer pool
tensors of attention layers.

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

from repro_torch.models import lm

NULL_BLOCK = 0


def table_row(blocks: list, width: int) -> np.ndarray:
    """One NULL-padded block-table row: entry j is the physical block
    holding token rows [j*block_size, (j+1)*block_size)."""
    row = np.full((width,), NULL_BLOCK, np.int64)
    row[: len(blocks)] = blocks
    return row


class BlockPool:
    """Host-side refcounting allocator over physical block ids. Block 0 is
    the null block and never handed out; ``alloc`` is all-or-nothing;
    ``free`` drops one owner and a block rejoins the free list at refcount
    0; a double free raises."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("pool needs >= 1 allocatable block + null block")
        self.n_blocks = n_blocks
        self._free: deque[int] = deque(range(1, n_blocks))
        self._refs = [0] * n_blocks

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n > len(self._free):
            return None
        ids = [self._free.popleft() for _ in range(n)]
        for b in ids:
            self._refs[b] = 1
        return ids

    def free(self, ids: list[int]) -> None:
        for b in ids:
            if self._refs[b] <= 0:
                raise RuntimeError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)


def init_paged_cache(cfg, n_blocks: int, block_size: int, dtype,
                     device) -> list:
    """One pool dict per layer (attention layers only in this slice), laid
    out by ``lm._layer_cache``."""
    return [lm._layer_cache(cfg, n_blocks, block_size, dtype, device)
            for _ in range(cfg.n_layers)]
