"""Tensor-parallel process groups for the port, and the launcher that runs
a function on N ranks.

The port's counterpart of ``make_tp_mesh`` (``repro/launch/mesh.py:43``):
the reference builds a ("model",) device mesh inside one process; the port
runs one process per rank over a ``torch.distributed`` process group, and
``dist.sharding.use_tp`` hands the group to the kernel dispatch.

Rank r takes ``cuda:(r % device_count)``. The backend follows from what
the ranks run on, and is printed by the caller:

  nccl  every rank has a card of its own
  gloo  ranks share a card (NCCL refuses two ranks on one card; gloo stages
        CUDA tensors through the host), or the ranks run on the CPU

``run_ranks`` starts the ranks with the spawn method (the caller may hold a
CUDA context already, which a forked child cannot use) and returns rank
0's result. The functions the ranks run live in the port package
(``launch/serve.py::serve_rank``, ``engine_rank`` and ``dense_rank``
here), so a rank imports torch and the port and nothing else. Every
collective has a timeout, so a rank that stops answering fails the run
instead of hanging it.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import multiprocessing
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro_torch.device import resolve_device

TIMEOUT_S = 120


def backend_for(n: int, device: torch.device) -> str:
    """NCCL when each of ``n`` ranks has a card of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device: torch.device) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % device_count)`` on the card."""
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def make_tp_group(n: int, rank: int, device, init_method: str,
                  timeout_s: int = TIMEOUT_S):
    """Join this process to an ``n``-rank group as ``rank`` and return the
    group (the default group). ``init_method`` is a ``tcp://host:port``
    address every rank is given; collectives time out after ``timeout_s``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(rank, dev))
    dist.init_process_group(backend_for(n, dev), init_method=init_method,
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_host(x):
    """Tensors (nested in dicts, lists, tuples) -> numpy arrays on the host,
    bf16 as f32, so a result pickles by value."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, fn, n, device, init_method, args, results):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    make_tp_group(n, rank, device, init_method)
    try:
        # rank 0 prints; the other ranks run the same code silently
        with contextlib.redirect_stdout(io.StringIO()) if rank else \
                contextlib.nullcontext():
            out = fn(rank, n, *args)
        if rank == 0:
            results.put(_to_host(out))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, *args, device="cuda"):
    """Run ``fn(rank, n, *args)`` on ``n`` spawned ranks joined in one
    group (``make_tp_group``) and return rank 0's result, its tensors as
    numpy arrays. ``fn`` must be importable by the ranks (a module-level
    function of the port). A rank that raises fails the call, and the
    other ranks are stopped."""
    dev = resolve_device(device)
    results = multiprocessing.get_context("spawn").SimpleQueue()
    ctx = tmp.spawn(_rank_main, nprocs=n, join=False,
                    args=(fn, n, str(dev), f"tcp://localhost:{_free_port()}",
                          args, results))
    while results.empty():
        if ctx.join(timeout=0.2):        # raises if a rank failed
            raise RuntimeError("the ranks finished without a result")
    out = results.get()
    while not ctx.join():
        pass
    return out


def engine_rank(rank: int, n: int, jobs: list) -> list:
    """One rank of a paged engine per job ``(np_tree, cfg, prompts,
    max_new, engine_kw)``, on the CPU: the tree is one the reference packed
    with ``quantize_tree(..., tp=n)`` (numpy leaves, see ``bridge.py``);
    the rank keeps its slice, serves ``prompts`` greedily under tensor
    parallelism, and returns the tokens, every decode step's logits and
    the engine's counters."""
    from repro_torch import bridge
    from repro_torch.serving import Engine, Request

    out = []
    for np_tree, cfg, prompts, max_new, engine_kw in jobs:
        params = bridge.qparams_from_jax(np_tree, cfg, device="cpu",
                                         tp_rank=rank, tp_size=n)
        eng = Engine(cfg, params, tp_group=dist.group.WORLD, **engine_kw)
        logits = []
        inner = eng._decode_fn

        def keep(*a, inner=inner, logits=logits):
            lg = inner(*a)
            logits.append(lg.clone())
            return lg

        eng._decode_fn = keep
        reqs = [Request(uid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        m = eng.run()
        out.append({"tokens": [r.out for r in reqs], "logits": torch.stack(logits),
                    "decode_steps": m["decode_steps"],
                    "prefill_chunks": m["prefill_chunks"],
                    "counters": m["metrics"]["counters"]})
    return out


def dense_rank(rank: int, n: int, cases: list) -> list:
    """One planned projection per case on this rank: ``(w (in, out),
    policy, role, x (M, in), backend)`` -> the leaf packed for ``n`` ranks
    with ``role``, the rank's slice of it (``qlinear.shard_weight``), and
    ``dense_serve`` of the whole ``x`` under ``use_tp``. Returns, per case,
    the output and whether the leaf was cut (False: its rule did not
    divide, and it ran whole)."""
    from repro_torch.core import qlinear
    from repro_torch.dist import sharding

    out = []
    with sharding.use_tp(dist.group.WORLD):
        for w, policy, role, x, backend in cases:
            qw = qlinear.quantize_weight(torch.from_numpy(np.asarray(w)), policy,
                                         tp_role=role, tp_shards=n)
            mine = qlinear.shard_weight(qw, rank, n)
            y = qlinear.dense_serve(mine, torch.from_numpy(np.asarray(x)),
                                    backend=backend)
            out.append((y, mine.tp_shards > 1))
    return out
