"""Tensor-parallel pieces of the port: the Megatron role of each
projection, the active TP context, and the two collectives the kernel
rules need.

The port's counterpart of the TP half of ``repro/dist/sharding.py``. The
reference wraps each kernel call in ``shard_map`` over a device mesh; the
port runs one process per rank over a ``torch.distributed`` process group
(``launch/mesh.py``), and ``kernels/registry.py::dispatch`` reads the
context set here. The logical-axis GSPMD rules (``use_rules``,
``PRESETS``) have no counterpart: the port has no GSPMD, and the serve
preset ``serve_tp`` replicates every activation the port touches.

The gather of column slices is an ``all_gather`` into one tensor per
rank, then a concatenation along the last dim. gloo takes CUDA tensors
for both collectives (it stages them through the host), so the same code
runs with NCCL (one rank per card), gloo on a shared card and gloo on the
CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch
import torch.distributed as dist

# Tensor-parallel role of each dense / expert projection (the reference's
# TP_ROLES): "col" shards the output (N) dim and gathers the output, "row"
# shards the contraction (K) dim and sums the partial outputs over ranks.
TP_ROLES = {
    "wq": "col", "wk": "col", "wv": "col", "wo": "row",
    "w_up": "col", "w_gate": "col", "w_down": "row",
    "lm_head": "col",
    "we_gate": "col", "we_up": "col", "we_down": "row",
}


@dataclasses.dataclass(frozen=True)
class TPContext:
    """The process group of a tensor-parallel run and this rank in it."""
    group: Optional[dist.ProcessGroup]
    rank: int
    world: int


_TP_CTX = threading.local()


@contextlib.contextmanager
def use_tp(group: Optional[dist.ProcessGroup] = None):
    """Activate tensor parallelism over ``group`` (the default group when
    None) for the kernel dispatches in the block: a leaf that carries a TP
    role runs its op's TP rule. Without it the same model code runs on one
    device. Nestable and thread-local, like the reference's ``use_tp``."""
    stack = getattr(_TP_CTX, "stack", None)
    if stack is None:
        stack = _TP_CTX.stack = []
    stack.append(TPContext(group, dist.get_rank(group), dist.get_world_size(group)))
    try:
        yield
    finally:
        stack.pop()


def active_tp() -> Optional[TPContext]:
    """The innermost ``use_tp`` context, or None."""
    stack = getattr(_TP_CTX, "stack", None)
    return stack[-1] if stack else None


def sum_ranks(t: torch.Tensor, ctx: TPContext) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks, on every rank."""
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=ctx.group)
    return t


def gather_cols(t: torch.Tensor, ctx: TPContext) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the last dim, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(ctx.world)]
    dist.all_gather(parts, t, group=ctx.group)
    return torch.cat(parts, dim=-1)
