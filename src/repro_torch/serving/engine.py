"""Streaming continuous-batching engine over the paged KV-cache pool.

The port's counterpart of the core of ``repro/serving/engine.py``: the
scheduling loop, chunked prefill, batched one-token decode, and
recompute-style preemption on block exhaustion, with the same host-side
policy:

  step()  admit from the bounded queue while a slot and the first chunk's
          blocks are free -> run one prefill chunk (round-robin over
          prefilling slots) -> run one batched decode step over all slots.

Inactive decode rows and pad rows of a chunk write the null block and are
masked out. Under an MoE model they still compete for expert capacity
(rows are dispatched in token order), so they are fed exactly as the
reference feeds them: token 0, position 0 for an inactive slot, token 0
past the prompt in a chunk of fixed ``chunk_size`` rows. A preempted request frees its blocks and is requeued at the
front with its generated tokens folded into the prompt. The first decode
step of a request re-feeds its last prompt token at row P, as in the
reference, so the two engines feed identical token streams.

The reference jit-compiles two fixed-shape step functions; the port runs
eagerly, calling the same forward on the same fixed shapes ((n_slots, 1)
decode, (1, chunk_size) prefill). Pools are updated in place.

Decode steps attend through the registry's paged attention ops on an int8
or int4 pool: ``paged_attention`` with ``kv_splits`` 1, the split-KV
``paged_attention_splitkv`` above 1 ("auto": the card's rule,
``kernels/paged_attention.py::auto_kv_splits``, on n_slots, KV heads and
``max_len``: 1 below 32768 rows; the reference takes one split per 4096
rows, at most 16, a TPU rule). On CUDA tensors those are
the port's kernels; the reference's engine attends through jnp there.
``attn_backend`` "ref" sends the attention op to its plain version on any
device, so a run on the card can hold the kernels against it.

Tensor parallelism: given a process group (``tp_group``), the engine runs
its prefill and decode forwards inside ``dist.sharding.use_tp``, over a
parameter tree that holds this rank's slice of every role-stamped leaf
(``lm.init_params(..., tp=N, rank=r)`` or the bridge). Everything else,
the KV pool, attention, norms, the embedding and the head included, is
whole on every rank, as the reference's ``serve_tp`` preset computes it.
The host scheduler runs unchanged and identically on every rank: the
logits are replicated, so every rank samples the same tokens and makes the
same decisions, and the collectives stay in step.

Not ported yet (each raises): whole-prompt admission, batched prefill,
the prefix-sharing radix cache, speculative decoding, ring-paged local
layers, the tracer, and seeded sampling (ROADMAP queue 1, items 5-6).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.dist import sharding
from repro_torch.kernels.paged_attention import auto_kv_splits
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import MetricsRegistry
from . import cache as C
from . import sampler as S


@dataclasses.dataclass
class Request:
    """One generation request (fields as in the reference): ``prompt`` (P,)
    token ids, ``max_new`` budget, optional ``eos_id``, ``priority`` (lower
    is preempted first), optional streaming ``on_token(token, done)``.
    Filled by the engine: ``out``, ``done``, ``rejected``, ``n_preempted``."""
    uid: int
    prompt: np.ndarray
    max_new: int = 16
    eos_id: Optional[int] = None
    priority: int = 0
    on_token: Optional[Callable[[int, bool], None]] = None
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False
    n_preempted: int = 0


_FREE, _PREFILL, _DECODE = 0, 1, 2


def _counter(metric: str, doc: str):
    """Engine counter attribute backed by the engine's metrics registry."""
    def _get(self) -> int:
        return int(self.obs.get(metric))

    def _set(self, v: int) -> None:
        self.obs.set_counter(metric, v)

    return property(_get, _set, doc=doc)


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    state: int = _FREE
    prompt: Optional[np.ndarray] = None   # effective prompt (+ regenerated)
    prefill_done: int = 0                 # prompt rows already in the cache
    pos: int = 0                          # next decode row (== ctx length)
    next_input: int = 0
    blocks: list = dataclasses.field(default_factory=list)
    admit_seq: int = 0


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


class Engine:
    """Paged continuous-batching engine (see the module docstring).

    ``cfg``/``params`` are a model config and a (quantize_tree'd) parameter
    dict; the pool and every step run on the parameters' device. Arguments
    mirror the reference's: ``n_slots`` (decode batch), ``max_len`` (max
    context rows, a multiple of ``block_size``), ``n_blocks`` (pool size
    incl. the null block; default every slot can hold max_len rows),
    ``chunk_size`` (prefill chunk, default two blocks), ``max_queue``,
    ``kv_splits`` ("auto" or an int >= 1; decode forwards only). The
    port's own ``attn_backend`` ("auto" or "ref") is the registry backend
    of the decode attention op; ``tp_group`` (a ``torch.distributed``
    process group) makes the forwards tensor-parallel over it.
    """

    def __init__(self, cfg, params, *, n_slots: int, max_len: int,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 chunk_size: Optional[int] = None, max_queue: int = 64,
                 prefill: str = "chunked", prefill_batch: int = 1,
                 prefix_cache: bool = False,
                 sampler: Optional[S.SamplerConfig] = None,
                 kv_splits="auto", attn_backend: str = "auto",
                 tp_group=None):
        if prefill != "chunked":
            raise _not_ported("whole-prompt admission", "queue 1, item 6")
        if prefill_batch != 1:
            raise _not_ported("batched prefill (prefill_batch > 1)",
                              "queue 1, item 6")
        if prefix_cache:
            raise _not_ported("the prefix-sharing radix cache",
                              "queue 1, item 6")
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} is not a multiple of "
                             f"block_size {block_size}")
        if chunk_size is None:
            chunk_size = min(2 * block_size, max_len)
            while max_len % chunk_size:
                chunk_size -= block_size
        if chunk_size % block_size or max_len % chunk_size:
            raise ValueError(f"chunk_size {chunk_size} must be a multiple of "
                             f"block_size and divide max_len")
        if kv_splits == "auto":
            self.kv_splits = auto_kv_splits(n_slots, cfg.n_kv_heads, max_len)
        else:
            self.kv_splits = int(kv_splits)
            if self.kv_splits < 1:
                raise ValueError(f"kv_splits must be >= 1: {kv_splits!r}")
        if attn_backend not in ("auto", "ref"):
            raise ValueError(f"attn_backend must be 'auto' or 'ref': "
                             f"{attn_backend!r}")
        self.attn_backend = attn_backend
        self.tp_group = tp_group

        self.cfg = cfg
        self.params = params
        self.device = lm.embed_table(params).device
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.chunk_size = chunk_size
        self.max_queue = max_queue
        self.nb_max = max_len // block_size
        self.n_blocks = n_blocks if n_blocks is not None \
            else n_slots * self.nb_max + 1
        self.sampler = sampler if sampler is not None else S.SamplerConfig()
        self.caches = C.init_paged_cache(cfg, self.n_blocks, block_size,
                                         lm.torch_dtype(cfg.dtype), self.device)
        self.pool = C.BlockPool(self.n_blocks)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: deque[Request] = deque()
        self.obs = MetricsRegistry()
        self._admit_counter = 0
        self._pf_rr = 0

    steps = _counter("engine_steps", "engine steps (admit+prefill+decode)")
    decode_steps = _counter("engine_decode_steps", "batched decode steps")
    prefill_chunks = _counter("engine_prefill_chunks", "prefill chunk launches")
    busy_slot_steps = _counter("engine_busy_slot_steps",
                               "sum over decode steps of active slots")
    preemptions = _counter("engine_preemptions", "slots evicted + requeued")
    rejections = _counter("engine_rejections", "admissions refused")
    prefill_tokens_computed = _counter("engine_prefill_tokens_computed",
                                       "real prompt rows run through prefill")

    # ---------------- device steps ----------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.int64,
                               device=self.device)

    def _tp(self):
        return sharding.use_tp(self.tp_group) if self.tp_group is not None \
            else contextlib.nullcontext()

    @torch.inference_mode()
    def _decode_fn(self, tables, tokens, pos) -> torch.Tensor:
        """One token for every slot: tokens (n_slots, 1), pos (n_slots,),
        tables (n_slots, nb_max). Returns (n_slots, V) f32 logits."""
        with obs_metrics.scoped(registry=self.obs), self._tp():
            h, _ = lm.forward(self.params, self.cfg, tokens, caches=self.caches,
                              pos=pos, block_tables=tables,
                              kv_splits=self.kv_splits,
                              attn_backend=self.attn_backend)
            return lm.logits_fn(self.params, self.cfg, h[:, -1:])[:, -1]

    @torch.inference_mode()
    def _prefill_fn(self, table_row, tokens, start) -> None:
        """One prompt chunk for one request: tokens (1, chunk_size) (pad
        rows zero), start (1,) first row index."""
        with obs_metrics.scoped(registry=self.obs), self._tp():
            lm.forward(self.params, self.cfg, tokens, caches=self.caches,
                       pos=start, block_tables=table_row[None])

    # ---------------- admission / preemption ----------------

    def _max_blocks_needed(self, P: int, max_new: int) -> int:
        rows = min(self.max_len, max(P + max_new, P + 1))
        return -(-rows // self.block_size)

    def submit(self, req: Request) -> bool:
        """Admission control: bounded queue + must-fit-alone check. Returns
        False (and marks the request rejected) when refused."""
        P = int(np.asarray(req.prompt).shape[0])
        if len(self.queue) >= self.max_queue \
                or P > self.max_len - 1 \
                or self._max_blocks_needed(P, req.max_new) > self.n_blocks - 1:
            req.rejected = True
            self.rejections += 1
            return False
        self.queue.append(req)
        return True

    def _table_row(self, slot: _Slot) -> np.ndarray:
        return C.table_row(slot.blocks, self.nb_max)

    def _pick_victim(self) -> Optional[int]:
        occupied = [i for i, s in enumerate(self.slots) if s.state != _FREE]
        if not occupied:
            return None
        return min(occupied, key=lambda i: (self.slots[i].req.priority,
                                            -self.slots[i].admit_seq))

    def _preempt(self, ix: int):
        """Evict slot ix: free its blocks and requeue the request at the
        front with its generated tokens folded into the prompt."""
        s = self.slots[ix]
        s.req.n_preempted += 1
        self.preemptions += 1
        if s.blocks:
            self.pool.free(s.blocks)
        self.slots[ix] = _Slot()
        self.queue.appendleft(s.req)

    def _make_room(self, n: int, requester_ix: int) -> bool:
        """Preempt victims until n blocks are free. False if the requester
        itself was evicted."""
        while self.pool.n_free < n:
            victim = self._pick_victim()
            if victim is None:
                return False
            self._preempt(victim)
            if victim == requester_ix:
                return False
        return True

    def _free_ix(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.state == _FREE:
                return i
        return None

    def _first_alloc_size(self, P: int) -> int:
        if P == 0:
            return 1
        return -(-min(self.chunk_size, P) // self.block_size)

    def _admit(self):
        """Move queued requests into free slots while the first chunk's
        blocks are free (admission never preempts)."""
        while self.queue:
            ix = self._free_ix()
            if ix is None:
                return
            req = self.queue[0]
            eff_prompt = np.concatenate(
                [np.asarray(req.prompt, np.int64).reshape(-1),
                 np.asarray(req.out, np.int64)])
            if self._first_alloc_size(len(eff_prompt)) > self.pool.n_free:
                return                       # wait for blocks to free up
            self.queue.popleft()
            self._admit_counter += 1
            slot = _Slot(req=req, prompt=eff_prompt,
                         admit_seq=self._admit_counter)
            self.slots[ix] = slot
            if len(eff_prompt) == 0:
                slot.state = _DECODE         # zero-block request
            else:
                slot.state = _PREFILL

    # ---------------- prefill ----------------

    def _do_prefill_chunk(self, ix: int):
        s = self.slots[ix]
        P = len(s.prompt)
        start = s.prefill_done
        real = min(self.chunk_size, P - start)
        # blocks cover real rows only: pad-row writes past the allocated
        # table entries fall into the null block
        need = -(-(start + real) // self.block_size) - len(s.blocks)
        if need > 0:
            if not self._make_room(need, ix):
                return                        # self-preempted
            s.blocks += self.pool.alloc(need)
        chunk = np.zeros((1, self.chunk_size), np.int64)
        chunk[0, :real] = s.prompt[start:start + real]
        self._prefill_fn(self._tensor(self._table_row(s)), self._tensor(chunk),
                         self._tensor([start]))
        self.prefill_chunks += 1
        s.prefill_done += real
        self.prefill_tokens_computed += real
        if s.prefill_done >= P:
            s.state = _DECODE
            s.pos = P
            s.next_input = int(s.prompt[-1])

    # ---------------- decode ----------------

    def _grow_for_decode(self):
        """Ensure every decoding slot owns the block its next row lands in,
        preempting (possibly the slot itself) on pool exhaustion."""
        for i in range(self.n_slots):
            s = self.slots[i]
            if s.state != _DECODE:
                continue
            need = s.pos // self.block_size + 1 - len(s.blocks)
            if need > 0:
                if not self._make_room(need, i):
                    continue
                s.blocks += self.pool.alloc(need)

    def _finish(self, ix: int):
        s = self.slots[ix]
        s.req.done = True
        if s.blocks:
            self.pool.free(s.blocks)
        self.slots[ix] = _Slot()

    def _do_decode(self):
        self._grow_for_decode()
        active = [i for i, s in enumerate(self.slots) if s.state == _DECODE]
        if not active:
            return
        tokens = [[s.next_input if s.state == _DECODE else 0] for s in self.slots]
        pos = [s.pos if s.state == _DECODE else 0 for s in self.slots]
        tables = np.zeros((self.n_slots, self.nb_max), np.int64)
        for i in active:
            tables[i] = self._table_row(self.slots[i])
        logits = self._decode_fn(self._tensor(tables), self._tensor(tokens),
                                 self._tensor(pos))
        nxt = S.sample(logits, self.sampler).tolist()
        self.decode_steps += 1
        self.busy_slot_steps += len(active)
        for i in active:
            s = self.slots[i]
            tok = int(nxt[i])
            req = s.req
            req.out.append(tok)
            s.next_input = tok
            s.pos += 1
            done = ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.out) >= req.max_new
                    or s.pos >= self.max_len - 1)
            if req.on_token is not None:
                req.on_token(tok, done)
            if done:
                self._finish(i)

    # ---------------- main loop ----------------

    def step(self) -> int:
        """Admit, run one prefill chunk, run one batched decode step.
        Returns the number of occupied slots."""
        self._admit()
        prefilling = [i for i, s in enumerate(self.slots) if s.state == _PREFILL]
        if prefilling:
            k = self._pf_rr % len(prefilling)
            self._pf_rr += 1
            self._do_prefill_chunk(prefilling[k])
        self._do_decode()
        self.steps += 1
        return sum(s.state != _FREE for s in self.slots)

    def run(self, max_steps: int = 10_000) -> dict:
        """Step until the queue and all slots drain (or max_steps)."""
        while (self.queue or any(s.state != _FREE for s in self.slots)) \
                and self.steps < max_steps:
            self.step()
        return self.metrics()

    def per_device_weight_bytes(self) -> int:
        """Bytes of every parameter tensor this engine holds on its device:
        under tensor parallelism the rank's slices of the role-stamped
        leaves plus everything replicated (the reference's counterpart
        counts the first mesh device's shards)."""
        def walk(x) -> int:
            if torch.is_tensor(x):
                return x.numel() * x.element_size()
            if dataclasses.is_dataclass(x):
                return sum(walk(getattr(x, f.name)) for f in dataclasses.fields(x))
            if isinstance(x, dict):
                return sum(walk(v) for v in x.values())
            if isinstance(x, (list, tuple)):
                return sum(walk(v) for v in x)
            return 0
        return walk(self.params)

    def metrics(self) -> dict:
        util = self.busy_slot_steps / max(self.decode_steps * self.n_slots, 1)
        free = self.pool.n_free
        self.obs.set_gauge("free_blocks", free)
        self.obs.set_gauge("used_blocks", self.n_blocks - 1 - free)
        return {
            "steps": self.decode_steps,
            "engine_steps": self.steps,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "preemptions": self.preemptions,
            "rejections": self.rejections,
            "slot_utilization": util,
            "metrics": self.obs.snapshot(),
        }
