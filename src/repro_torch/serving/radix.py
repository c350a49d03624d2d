"""Prefix-sharing radix cache over the refcounted paged block pool.

The port's counterpart of ``repro/serving/radix.py``. The K/V rows a
prefill writes for position t are a function of ``tokens[:t + 1]`` only,
so fully filled prompt blocks are content-addressable: a request whose
prompt shares a block-aligned prefix with one already prefilled attaches
the filled physical blocks by a refcount bump instead of prefilling them
again. The tree has one node per block: its edge label is the block's
``block_size`` token ids and it holds the physical block id. Host-side
Python over integer ids only.

Ownership (all refcounts, ``BlockPool.ref`` / ``free``):

  * every node holds one pool reference on its block while it exists, so
    a cached block never returns to the free list while the tree maps
    tokens to it;
  * ``match`` adds one reference per returned block for the caller, who
    frees them like blocks it allocated;
  * ``evict_one`` drops the least recently used leaf whose block has no
    owner besides the tree (refcount 1); interior nodes outlive their
    children, so every path in the tree is backed by live blocks.

Only prefill-written blocks are inserted, full blocks only: decode writes
row P with the re-fed last prompt token, which differs from what
prefilling ``prompt + out`` writes there.
"""

from __future__ import annotations

from typing import Optional

from .cache import BlockPool


class _Node:
    """One cached block: edge label ``key`` (its token ids), the physical
    ``block`` id and an LRU stamp."""

    __slots__ = ("key", "block", "parent", "children", "last_use")

    def __init__(self, key: Optional[tuple], block: int,
                 parent: Optional["_Node"], last_use: int):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.last_use = last_use


class RadixCache:
    """Block-aligned token prefixes -> physical block ids of the paged
    pool, with LRU eviction of unreferenced entries. Counters
    ``hit_tokens`` / ``miss_tokens`` are the engine's to record, once per
    admission; ``evictions`` counts ``evict_one``'s drops."""

    def __init__(self, pool: BlockPool, block_size: int):
        self.pool = pool
        self.block_size = block_size
        self._root = _Node(None, -1, None, 0)
        self._clock = 0
        self.n_nodes = 0
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evictions = 0

    def _key(self, tokens, i: int) -> tuple:
        bs = self.block_size
        return tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def match(self, tokens) -> list[int]:
        """Longest cached block-aligned prefix of ``tokens``: its block ids,
        each with one reference added for the caller. Touches the matched
        path for LRU; records no hit or miss (an admission that fails is
        probed again)."""
        self._clock += 1
        node, out = self._root, []
        for i in range(len(tokens) // self.block_size):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            self.pool.ref([child.block])
            child.last_use = self._clock
            out.append(child.block)
            node = child
        return out

    def insert(self, tokens, blocks: list[int], *, at=None,
               done: int = 0) -> tuple[_Node, int]:
        """Index the full blocks of ``tokens`` (the rows prefilled so far),
        held by ``blocks``; each new node takes one reference. Existing
        nodes are kept (a private copy of the same content stays
        unindexed). Returns ``(deepest node, blocks indexed)``, to pass
        back as ``at`` / ``done`` on the next chunk's insert. The resume
        node must hold the slot's own last block, whose reference keeps it
        (and so its path) in the tree until that chunk: a node found
        holding another request's copy may be evicted once that request
        ends, so then the hint is ``(None, 0)`` and the next insert walks
        from the root."""
        self._clock += 1
        node = self._root if at is None else at
        n = len(tokens) // self.block_size
        for i in range(done, n):
            key = self._key(tokens, i)
            child = node.children.get(key)
            if child is None:
                child = _Node(key, blocks[i], node, self._clock)
                self.pool.ref([blocks[i]])
                node.children[key] = child
                self.n_nodes += 1
            child.last_use = self._clock
            node = child
        if n and node.block != blocks[n - 1]:
            return None, 0
        return node, n

    def _evictable(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if not n.children and self.pool.refcount(n.block) == 1:
                yield n
            stack.extend(n.children.values())

    def evict_one(self) -> bool:
        """Drop the least recently used unreferenced leaf, returning its
        block to the free list. False when nothing is evictable."""
        victim = min(self._evictable(), key=lambda n: n.last_use, default=None)
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        self.n_nodes -= 1
        self.evictions += 1
        self.pool.free([victim.block])
        return True

    def reset(self) -> None:
        """Drop the whole index and the tree's references: blocks attached
        to live requests survive through their own."""
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.free([n.block])
        self._root.children.clear()
        self.n_nodes = 0

    @property
    def n_cached_blocks(self) -> int:
        return self.n_nodes

    def metrics(self) -> dict:
        return {"cached_blocks": self.n_nodes, "hit_tokens": self.hit_tokens,
                "miss_tokens": self.miss_tokens, "evictions": self.evictions}
