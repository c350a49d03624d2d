"""Streaming continuous-batching engine over the paged KV-cache pool.

The port's counterpart of ``repro/serving/engine.py``, with the same
host-side policy. Each ``step()``:

  admit from the bounded queue while a slot and the first chunk's blocks
  are free -> run one prefill chunk step (round-robin over prefilling
  slots, up to ``prefill_batch`` of them in one batched chunk) -> in spec
  mode, one drafter catch-up chunk -> one batched decode step (in spec
  mode, one speculative round).

The reference jit-compiles fixed-shape step functions; the port runs
eagerly, calling the same forward on the same fixed shapes: ``(n_slots,
1)`` decode, ``(prefill_batch, chunk_size)`` prefill, ``(1, P)``
whole-prompt prefill, ``(n_slots, spec_k + 1)`` verify. Pools are updated
in place.

Inactive decode rows and pad rows write the null block and are masked
out. Under an MoE model they still compete for expert capacity (rows are
dispatched in token order), so they are fed exactly as the reference feeds
them: token 0, position 0 for an inactive slot, token 0 past the prompt in
a chunk of fixed ``chunk_size`` rows, an all-null table for a pad row of a
batched chunk. A preempted request frees its blocks and is requeued at the
front with its generated tokens folded into the prompt. The first decode
step of a request re-feeds its last prompt token at row P, as in the
reference, so the two engines feed identical token streams.

Sampling (serving/sampler.py): temperature -> top-k -> top-p -> a seeded
Gumbel-max draw per row, with per-request temperature and top-p; greedy
rows (the default) are the argmax of the raw logits, ties to the first
index. Draws depend only on (seed, uid, sample index), never on the slot
or the batch.

Prefix sharing (``prefix_cache``, chunked prefill only): admission looks
the effective prompt up in the radix cache (serving/radix.py), attaches
the longest cached block-aligned prefix by refcount and prefills after it;
a full-prompt hit skips prefill and re-feeds the last prompt token at row
P. After every chunk the request's full prompt blocks are inserted. When
the pool runs low, unreferenced cached blocks are evicted (least recently
used leaf first) before drafter blocks, and drafter blocks before any
request is preempted.

Whole-prompt admission (``prefill="whole"``): one ``(1, P)`` forward per
admitted request, its K/V scattered into the slot's blocks
(``cache.write_prompt_rows``). It disables the radix cache and batched
prefill, as the reference does; ``ContinuousBatcher`` (serving/
scheduler.py) is a shim over it.

Self-speculative decoding (``spec_draft_params``): a low-bit drafter (the
same weights packed under another plan, typically w2a2) proposes
``spec_k`` tokens a round through ``spec_k + 1`` one-token forwards over
its own paged pool, a second cache tree addressed by the same block ids;
the target verifies them in one ``(n_slots, spec_k + 1)`` forward, and
lossless rejection sampling (serving/spec.py) emits 1..spec_k+1 tokens a
slot. Drafter blocks are best effort: reclaimed before any target block,
and a slot whose drafter lags rides the same two forwards undrafted (one
token). The drafter catches up by replaying the fed-token stream
(``_fed_stream``) in chunks.

Decode steps attend through the registry's paged attention ops on an int8
or int4 pool: ``paged_attention`` with ``kv_splits`` 1, the split-KV
``paged_attention_splitkv`` above 1 ("auto": the card's rule,
``kernels/paged_attention.py::auto_kv_splits``, on n_slots, KV heads and
the rows a layer reads, ``max_len`` or on a local layer min(max_len,
window): 1 below 32768 rows; the reference takes one split per 4096 rows,
at most 16, a TPU rule; an explicit kv_splits applies to every layer, as
in the reference). So do the drafter's one-token steps. Local
(sliding-window) layers keep the full block table, masked to the window
at attention time, as the reference's engine does without ``ring``.
Multi-row forwards (prefill chunks, verify) attend through the plain
gathered path, as in the reference, and the whole-prompt forward through
plain causal attention. So greedy spec decoding attends through another
float formulation than plain decoding (S = k+1 against S = 1) and may pick
the other token at a near tie, where the reference's spec decoding is
bit-identical to its plain decoding. ``attn_backend`` "ref" sends the
attention op to its plain version on any device.

Tensor parallelism: given a process group (``tp_group``), the engine runs
its forwards inside ``dist.sharding.use_tp``, over a parameter tree that
holds this rank's slice of every role-stamped leaf. Everything else, the
KV pool, attention, norms, the embedding and the head included, is whole
on every rank. The host scheduler, the sampler and the radix cache run
identically on every rank: the logits are replicated, so every rank makes
the same decisions. Spec mode under tensor parallelism is refused (the
drafter's TP rules: ROADMAP queue 1, item 11).

Ring-paged local layers (``ring=True``, the reference's engine.py:354-418):
every local layer keeps a slot's K/V in a ring of ``ring_len`` = ceil((window
+ span - 1) / block_size) blocks from a second pool with its own id space
and null block (span: ``chunk_size`` under chunked prefill, at least
spec_k + 1 in spec mode, 1 under whole prefill), so that local-layer memory
is flat in the context. A slot gets its ring, and a drafter ring in spec
mode, whole at admission and frees them at finish and at preemption; the
ring pool holds every slot's, so ring allocation never fails and never
preempts. Every forward takes the rings; an inert row's is all null. The
one-token forwards also take each ring as an absolute table (entry j: ring
block j % ring_len) of their table's width, built once at admission, which
the paged attention ops read as they read a block table
(models/layers.py). A whole prompt's last min(P, ring rows) rows are
scattered into the ring from the host side. ``ring`` needs local layers and
a window, and refuses ``prefix_cache`` (a radix hit would skip writing the
matched rows into the ring), in the reference's words.

Recurrent models (recurrentgemma's RG-LRU layers, rwkv6's RWKV6 layers;
the reference's engine.py:419-463, :934-937 and :1001-1004): their O(1)
state stays per slot beside the pools (serving/cache.py). A slot's state
is zeroed at admission, so a preempted request re-prefills from a zero
state; a prefill chunk runs on the slot's state alone (``prefill_batch``
is forced to 1) and its last chunk is exact-length, since a pad row would
advance the state; a decode step advances only the decoding slots' states
(idle and prefilling slots keep theirs); the radix cache is off (a state
has no block boundary to share at) and spec mode is refused (the drafter
cannot rewind a scan state past rejected tokens).

Tracing (``tracer``, obs/trace.py; ``attach_tracer``): the host loop calls
the tracer's hooks where the reference's engine does: submit and reject,
admit, each prefill chunk, each emitted token, preempt and finish, and the
step's phases (admit, prefill, draft_prefill, decode, with evict, preempt
and compile nested inside them) with the pool and queue gauges at the
step's end. A hook reads no tensor and launches nothing; with no tracer
each is one ``is None`` check. A forward during which a kernel library was
built or loaded on first use (kernels/build.py) counts
``kernel_builds_total{fn}``, observes ``kernel_build_s{fn}`` and, traced,
records a ``compile:<fn>`` slice. ``metrics()`` adds the tracer's
``latency`` and ``phases`` summaries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import zlib
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import STATE_TYPES
from repro_torch.dist import sharding
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import auto_kv_splits
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import MetricsRegistry
from . import cache as C
from . import sampler as S
from . import spec as SP
from .radix import RadixCache


@dataclasses.dataclass
class Request:
    """One generation request (fields as in the reference): ``prompt`` (P,)
    token ids, ``max_new`` budget, optional ``eos_id``, ``priority`` (lower
    is preempted first), optional streaming ``on_token(token, done)``,
    per-request sampler overrides ``temperature`` / ``top_p`` (None: the
    engine's ``SamplerConfig``; the uid is the request's draw stream).
    Filled by the engine: ``out``, ``done``, ``rejected``, ``n_preempted``."""
    uid: int
    prompt: np.ndarray
    max_new: int = 16
    eos_id: Optional[int] = None
    priority: int = 0
    on_token: Optional[Callable[[int, bool], None]] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
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
    # spec mode: drafter blocks (same id space, the drafter's cache tree)
    # and how many drafter rows mirror the target's fed-token stream
    draft_blocks: list = dataclasses.field(default_factory=list)
    draft_done: int = 0
    # radix insert resume hint: deepest indexed node and blocks indexed
    radix_node: object = None
    radix_done: int = 0
    # ring-paged local layers: the slot's ring and its drafter ring (ring
    # pool ids, held for the whole occupancy) and each as an absolute table
    # of nb_spec entries (C.ring_abs_row)
    ring_blocks: list = dataclasses.field(default_factory=list)
    draft_ring_blocks: list = dataclasses.field(default_factory=list)
    ring_abs: Optional[np.ndarray] = None
    draft_ring_abs: Optional[np.ndarray] = None


class Engine:
    """Paged continuous-batching engine (see the module docstring).

    ``cfg``/``params`` are a model config and a (quantize_tree'd) parameter
    dict; the pool and every step run on the parameters' device. Arguments
    mirror the reference's: ``n_slots`` (decode batch), ``max_len`` (max
    context rows, a multiple of ``block_size``), ``n_blocks`` (pool size
    incl. the null block; default every slot can hold max_len rows, in both
    trees in spec mode), ``chunk_size`` (prefill chunk, default two
    blocks), ``max_queue``, ``prefill`` ("chunked" or "whole"),
    ``prefill_batch`` (requests a prefill chunk step, clamped to n_slots;
    1 in whole mode), ``prefix_cache`` (the radix cache; off in whole
    mode), ``sampler`` (``SamplerConfig``), ``spec_draft_params`` /
    ``spec_draft_cfg`` / ``spec_k`` (the drafter's packed tree, its config,
    default ``cfg``, and drafts a round), ``kv_splits`` ("auto" or an int
    >= 1; one-token forwards only; "auto" is chosen per layer,
    ``layer_kv_splits``, and ``kv_splits`` holds the global layers'),
    ``ring`` (ring-paged local layers) and ``tracer`` (an
    ``obs.trace.Tracer``). The port's own ``attn_backend`` ("auto" or
    "ref") is the registry backend of the decode attention op;
    ``tp_group`` (a ``torch.distributed`` process group) makes the forwards
    tensor-parallel over it; the pools and rings are whole on every rank.
    """

    def __init__(self, cfg, params, *, n_slots: int, max_len: int,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 chunk_size: Optional[int] = None, max_queue: int = 64,
                 prefill: str = "chunked", prefill_batch: int = 1,
                 prefix_cache: bool = False,
                 sampler: Optional[S.SamplerConfig] = None,
                 spec_draft_params=None, spec_draft_cfg=None, spec_k: int = 4,
                 kv_splits="auto", attn_backend: str = "auto",
                 tp_group=None, ring: bool = False, tracer=None):
        if prefill not in ("chunked", "whole"):
            raise ValueError(f"prefill must be 'chunked' or 'whole': {prefill!r}")
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

        def layer_splits(c) -> tuple:
            """Each layer's kv_splits; a recurrent layer reads no K/V: 1."""
            if kv_splits != "auto":
                return tuple(1 if t in STATE_TYPES else self.kv_splits
                             for t in c.layer_types())
            return tuple(1 if t in STATE_TYPES else
                         auto_kv_splits(n_slots, c.n_kv_heads, max_len,
                                        c.window if t == "local" else None)
                         for t in c.layer_types())
        if attn_backend not in ("auto", "ref"):
            raise ValueError(f"attn_backend must be 'auto' or 'ref': "
                             f"{attn_backend!r}")
        self.spec = spec_draft_params is not None
        self.spec_k = int(spec_k)
        if self.spec:
            if prefill != "chunked":
                raise ValueError("spec decoding requires chunked prefill")
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1: {spec_k!r}")
            if tp_group is not None:
                raise NotImplementedError(
                    "spec decoding under tensor parallelism (the drafter's TP "
                    "rules) is not ported yet: ROADMAP queue 1, item 11")
        self.attn_backend = attn_backend
        self.tp_group = tp_group
        # ring-paged local layers: the ring carries span - 1 rows past the
        # window, because a multi-row forward attends before it scatters and
        # may write up to span - 1 pad or rejected rows past the kept
        # position; those alias rows a full R below, outside every window
        self.ring_len = self.n_ring_blocks = 0
        if ring:
            if "local" not in cfg.layer_types() or not cfg.window:
                raise ValueError(
                    "ring=True requires local attention layers with a "
                    "sliding window (cfg.pattern / cfg.window)")
            if prefix_cache:
                raise ValueError(
                    "ring=True is incompatible with prefix_cache: a radix "
                    "hit skips prefill for the matched rows, which would "
                    "leave their ring slots unwritten")
            span = chunk_size if prefill == "chunked" else 1
            if self.spec:
                span = max(span, self.spec_k + 1)
            self.ring_len = -(-(cfg.window + span - 1) // block_size)
            self.n_ring_blocks = (2 if self.spec else 1) * n_slots * self.ring_len + 1

        self.cfg = cfg
        self.params = params
        self.device = lm.embed_table(params).device
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.chunk_size = chunk_size
        self.max_queue = max_queue
        self.prefill_mode = prefill
        self.nb_max = max_len // block_size
        self.n_blocks = n_blocks if n_blocks is not None \
            else (2 if self.spec else 1) * n_slots * self.nb_max + 1
        # verify and draft tables are widened past nb_max, so the up to k
        # overflow rows near the context limit land in the null block
        self.nb_spec = self.nb_max + (
            -(-(self.spec_k + 1) // block_size) if self.spec else 0)
        self.sampler = sampler if sampler is not None else S.SamplerConfig()
        dtype = lm.torch_dtype(cfg.dtype)
        self.caches = C.init_paged_cache(cfg, self.n_blocks, block_size, dtype,
                                         self.device, self.n_ring_blocks, n_slots)
        self.pool = C.BlockPool(self.n_blocks)
        # the ring pool: its own ids and null block, one ring a slot (and a
        # drafter ring), so allocating a ring never fails or preempts
        self.ring_pool = C.BlockPool(self.n_ring_blocks) if self.ring_len else None
        self.draft_params = self.draft_cfg = self.draft_caches = None
        # kv_splits of each layer's one-token forwards (target, drafter)
        self.layer_kv_splits = layer_splits(cfg)
        self.draft_layer_kv_splits = None
        if self.spec:
            if cfg.has_state:
                raise NotImplementedError(
                    "spec decoding: recurrent per-slot state (the drafter "
                    "cannot rewind a scan state past rejected tokens)")
            self.draft_params = spec_draft_params
            self.draft_cfg = spec_draft_cfg if spec_draft_cfg is not None else cfg
            self.draft_caches = C.init_paged_cache(
                self.draft_cfg, self.n_blocks, block_size, dtype, self.device,
                self.n_ring_blocks)
            self.draft_layer_kv_splits = layer_splits(self.draft_cfg)
        # a pad row would advance a recurrent state: one request a chunk
        self.prefill_batch = 1 if cfg.has_state or prefill == "whole" \
            else max(1, min(prefill_batch, n_slots))
        # a per-slot state has no block boundary to share a prefix at
        self.radix = RadixCache(self.pool, block_size) \
            if prefix_cache and prefill == "chunked" and not cfg.has_state else None
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: deque[Request] = deque()
        self.obs = MetricsRegistry()
        self.tracer = tracer
        self._peaks: dict[str, int] = {}
        self._admit_counter = 0
        self._pf_rr = 0
        self._dpf_rr = 0

    steps = _counter("engine_steps", "engine steps (admit+prefill+decode)")
    decode_steps = _counter("engine_decode_steps", "batched decode steps")
    prefill_chunks = _counter("engine_prefill_chunks",
                              "prefill chunk launches (a batched launch is 1)")
    busy_slot_steps = _counter("engine_busy_slot_steps",
                               "sum over decode steps of active slots")
    preemptions = _counter("engine_preemptions", "slots evicted + requeued")
    rejections = _counter("engine_rejections", "admissions refused")
    prefill_tokens_computed = _counter("engine_prefill_tokens_computed",
                                       "real prompt rows run through prefill")
    prefill_tokens_shared = _counter("engine_prefill_tokens_shared",
                                     "prompt rows attached from the radix cache")
    spec_rounds = _counter("spec_rounds_total",
                           "speculative draft+verify rounds")
    spec_draft_tokens = _counter("spec_draft_tokens_total",
                                 "draft tokens proposed to the verifier")
    spec_accepted = _counter("spec_accepted_total",
                             "draft tokens accepted AND emitted")
    spec_emitted = _counter("spec_emitted_total",
                            "tokens emitted by speculative rounds")
    spec_draft_evictions = _counter("spec_draft_evictions_total",
                                    "drafter-KV evictions under pool pressure")
    spec_draft_prefills = _counter("spec_draft_prefill_chunks_total",
                                   "drafter catch-up chunk launches")

    # ---------------- device steps ----------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.int64,
                               device=self.device)

    def _tp(self):
        return sharding.use_tp(self.tp_group) if self.tp_group is not None \
            else contextlib.nullcontext()

    def attach_tracer(self, tracer) -> None:
        """Attach (or swap, or with None drop) the lifecycle tracer, e.g.
        after an untraced warm-up."""
        self.tracer = tracer

    _NULL_CTX = contextlib.nullcontext()

    def _phase(self, name: str):
        """The tracer's phase context (a shared no-op without a tracer)."""
        tr = self.tracer
        return tr.phase(name) if tr is not None else Engine._NULL_CTX

    @contextlib.contextmanager
    def _run(self, name: str):
        """Around one step function: its kernel dispatches land in ``obs``;
        where a kernel library was built or loaded on first use during it,
        its wall time is a build event (``kernel_builds_total{fn}``,
        ``kernel_build_s{fn}``, and a ``compile:<fn>`` slice when
        traced)."""
        tr = self.tracer
        before = build.loaded()
        t0 = tr.now() if tr is not None else time.perf_counter()
        with obs_metrics.scoped(registry=self.obs), self._tp():
            yield
        if build.loaded() > before:
            t1 = tr.now() if tr is not None else time.perf_counter()
            self.obs.inc("kernel_builds_total", fn=name)
            self.obs.observe("kernel_build_s", t1 - t0, fn=name)
            if tr is not None:
                tr.add_slice(f"compile:{name}", t0, t1)

    def _forward(self, draft: bool, tokens, pos, tables, rings=None,
                 slot: Optional[int] = None, active=None) -> torch.Tensor:
        """Final hidden states (B, S, D) of the target's (or the drafter's)
        forward over its paged pool; ``rings`` is ``_ring_tables``'s pair.
        Recurrent state: ``slot`` runs a one-row forward on that slot's
        state alone; ``active`` (n_slots,) bool limits a batched step's
        state advance to its rows."""
        params, cfg, caches, splits = (
            self.draft_params, self.draft_cfg, self.draft_caches,
            self.draft_layer_kv_splits) if draft else \
            (self.params, self.cfg, self.caches, self.layer_kv_splits)
        if slot is not None:
            caches = C.slot_view(caches, slot)
        ring, ring_abs = rings if rings is not None else (None, None)
        h, _ = lm.forward(params, cfg, tokens, caches=caches, pos=pos,
                          block_tables=tables, ring_tables=ring, ring_abs=ring_abs,
                          kv_splits=splits, attn_backend=self.attn_backend,
                          active=active)
        return h

    def _logits(self, draft: bool, h) -> torch.Tensor:
        params, cfg = (self.draft_params, self.draft_cfg) if draft else \
            (self.params, self.cfg)
        return lm.logits_fn(params, cfg, h)

    @torch.inference_mode()
    def _decode_fn(self, tables, tokens, pos, rings=None, active=None) -> torch.Tensor:
        """One token for every slot: tokens (n_slots, 1), pos (n_slots,),
        tables (n_slots, nb_max), ``rings`` the ring tables of a ring
        engine, ``active`` (n_slots,) the decoding slots of a recurrent
        model (the others keep their state). Returns (n_slots, V) f32
        logits."""
        with self._run("decode"):
            h = self._forward(False, tokens, pos, tables, rings, active=active)
        return self._logits(False, h[:, -1:])[:, -1]

    @torch.inference_mode()
    def _prefill_fn(self, tables, tokens, starts, draft: bool = False,
                    rings=None, slot: Optional[int] = None) -> None:
        """One chunk for up to prefill_batch requests: tokens (Bp,
        chunk_size) (pad rows zero), starts (Bp,) first row indices, tables
        (Bp, width) (a pad row all null, its ring too); the drafter's tree
        with ``draft``. A recurrent model's chunk is one request's, of its
        exact length, on ``slot``'s state."""
        with self._run("draft_prefill" if draft else "prefill"):
            self._forward(draft, tokens, starts, tables, rings, slot=slot)

    @torch.inference_mode()
    def _prefill_whole_fn(self, ix: int, prompt) -> None:
        """One whole-prompt forward (1, P) without a cache, its per-layer
        K/V scattered into slot ``ix``'s blocks (a local layer's into its
        ring on a ring engine) and its final recurrent states into the
        slot's."""
        s = self.slots[ix]
        with self._run("prefill_whole"):
            _, rows = lm.forward(self.params, self.cfg, prompt,
                                 collect_cache=True)
        C.write_prompt_rows(C.slot_view(self.caches, ix), rows, s.blocks,
                            self.block_size, self.cfg.kv_cache_dtype,
                            self.cfg.layer_types(),
                            s.ring_blocks if self.ring_len else None)

    @torch.inference_mode()
    def _verify_fn(self, tables, tokens, pos, rings=None) -> torch.Tensor:
        """The target over [F[pos], d_1..d_k] of every slot: tokens
        (n_slots, k+1), pos (n_slots,), tables (n_slots, nb_spec). Returns
        (n_slots, k+1, V) f32 logits. Rows past the accepted prefix leave
        stale K/V that the next round's forward rewrites before any emitted
        query attends them."""
        with self._run("verify"):
            h = self._forward(False, tokens, pos, tables, rings)
        return self._logits(False, h)

    @torch.inference_mode()
    def _draft_fn(self, tables, first, pos, rows, rings=None):
        """spec_k + 1 drafter one-token steps over [F[pos], d_1..d_k],
        writing drafter rows pos..pos+k (the (k+1)-th step only writes its
        row, so a fully accepted round leaves every drafter row below the
        new position holding the token the target kept). Step i draws d_i
        under ``TAG_DRAFT``, step i. Returns drafts (n_slots, k) and their
        distributions (n_slots, k, V)."""
        uids, sidx, temp, topp = rows
        k = self.spec_k
        tok, drafts, ps = first[:, None], [], []
        for i in range(k + 1):
            with self._run("draft"):
                h = self._forward(True, tok, pos + i, tables, rings)
            if i == k:
                break
            p = S.probs(self._logits(True, h)[:, -1], temp, self.sampler.top_k, topp)
            noise = S.gumbel(self.sampler.seed, uids, sidx, S.TAG_DRAFT,
                             p.shape[-1], step=i)
            tok = S.draw_from_noise(p, noise)[:, None]
            drafts.append(tok[:, 0])
            ps.append(p)
        return torch.stack(drafts, 1), torch.stack(ps, 1)

    @torch.inference_mode()
    def _spec_accept_fn(self, logits, drafts, p_draft, drafting, rows):
        """The target's (n_slots, k+1, V) logits through the same sampler
        stack as plain decode, then lossless rejection sampling. Rows that
        did not draft get zeroed drafter probs: no accepts, and the
        residual is a plain decode draw. Returns (n_acc, tokens (n_slots,
        k+1))."""
        uids, sidx, temp, topp = rows
        n, k1, V = logits.shape
        p_t = S.probs(logits.reshape(n * k1, V), temp.repeat_interleave(k1),
                      self.sampler.top_k, topp.repeat_interleave(k1))
        p_d = torch.where(drafting[:, None, None], p_draft,
                          torch.zeros_like(p_draft))
        return SP.reject_sample(drafts, p_d, p_t.reshape(n, k1, V),
                                self.sampler.seed, uids, sidx)

    # ---------------- admission / preemption ----------------

    def _max_blocks_needed(self, P: int, max_new: int) -> int:
        rows = min(self.max_len, max(P + max_new, P + 1))
        return -(-rows // self.block_size)

    def submit(self, req: Request) -> bool:
        """Admission control: bounded queue + must-fit-alone check (which
        ignores prefix sharing: a cached prefix can be evicted before the
        request runs). Returns False (and marks the request rejected) when
        refused."""
        P = int(np.asarray(req.prompt).shape[0])
        if len(self.queue) >= self.max_queue \
                or P > self.max_len - 1 \
                or self._max_blocks_needed(P, req.max_new) > self.n_blocks - 1:
            req.rejected = True
            self.rejections += 1
            if self.tracer is not None:
                self.tracer.on_reject(req.uid, P)
            return False
        self.queue.append(req)
        if self.tracer is not None:
            self.tracer.on_submit(req.uid, P)
        return True

    def _table_row(self, slot: _Slot) -> np.ndarray:
        return C.table_row(slot.blocks, self.nb_max)

    def _note_blocks(self, kind: str, n: int) -> None:
        """The high-water blocks one request holds, by kind (target, draft,
        ring), as the gauge ``pool_blocks_peak{kind}``: the target's grows
        with the context, a ring engine's ring peak stays ring_len."""
        if n > self._peaks.get(kind, 0):
            self._peaks[kind] = n
            self.obs.set_gauge("pool_blocks_peak", n, kind=kind)

    def _ring_tables(self, pairs, n_rows: int, draft: bool = False,
                     width: Optional[int] = None):
        """The ring tables of a batched step, or None without a ring:
        ``pairs`` (batch row j, slot i) place slot i's ring (its drafter's
        with ``draft``) at row j, every other row all null, so an inert row
        writes only the ring pool's null block. Returns (rings (n_rows,
        ring_len), their absolute tables (n_rows, ``width``), or None
        without a width)."""
        if not self.ring_len:
            return None
        rings = np.full((n_rows, self.ring_len), C.NULL_BLOCK, np.int64)
        absolute = None if width is None else \
            np.full((n_rows, width), C.NULL_BLOCK, np.int64)
        for j, i in pairs:
            s = self.slots[i]
            blocks, row = (s.draft_ring_blocks, s.draft_ring_abs) if draft else \
                (s.ring_blocks, s.ring_abs)
            if blocks:
                rings[j] = blocks
                if absolute is not None:
                    absolute[j] = row[:width]
        return self._tensor(rings), \
            None if absolute is None else self._tensor(absolute)

    def _pick_victim(self) -> Optional[int]:
        occupied = [i for i, s in enumerate(self.slots) if s.state != _FREE]
        if not occupied:
            return None
        return min(occupied, key=lambda i: (self.slots[i].req.priority,
                                            -self.slots[i].admit_seq))

    def _release(self, s: _Slot) -> None:
        if s.blocks:
            self.pool.free(s.blocks)
        if s.draft_blocks:
            self.pool.free(s.draft_blocks)
        if s.ring_blocks:
            self.ring_pool.free(s.ring_blocks)
        if s.draft_ring_blocks:
            self.ring_pool.free(s.draft_ring_blocks)

    def _preempt(self, ix: int):
        """Evict slot ix: free its blocks (those the radix tree indexes stay
        cached) and requeue the request at the front with its generated
        tokens folded into the prompt."""
        s = self.slots[ix]
        s.req.n_preempted += 1
        self.preemptions += 1
        self._release(s)
        self.slots[ix] = _Slot()
        self.queue.appendleft(s.req)
        if self.tracer is not None:
            self.tracer.on_preempt(s.req.uid)

    def _make_room(self, n: int, requester_ix: int) -> bool:
        """Free blocks until n are: evict unreferenced radix blocks, then
        drafter blocks, then preempt victims. False if the requester itself
        was evicted."""
        while self.pool.n_free < n:
            if self.radix is not None:
                with self._phase("evict"):
                    evicted = self.radix.evict_one()
                if evicted:
                    continue
            if self._evict_one_draft():
                continue
            victim = self._pick_victim()
            if victim is None:
                return False
            with self._phase("preempt"):
                self._preempt(victim)
            if victim == requester_ix:
                return False
        return True

    def _evict_one_draft(self) -> bool:
        """Reclaim one slot's whole drafter KV (the largest holding first):
        the slot decodes undrafted until the catch-up rebuilds it."""
        cand = [i for i, s in enumerate(self.slots) if s.draft_blocks]
        if not cand:
            return False
        s = self.slots[max(cand, key=lambda j: len(self.slots[j].draft_blocks))]
        self.pool.free(s.draft_blocks)
        s.draft_blocks = []
        s.draft_done = 0
        self.spec_draft_evictions += 1
        return True

    def _alloc_draft(self, ix: int, n: int) -> bool:
        """n drafter blocks for slot ix without preempting anyone: evict
        unreferenced radix blocks, else give up (no draft this round)."""
        while self.pool.n_free < n:
            if self.radix is None or not self.radix.evict_one():
                return False
        self.slots[ix].draft_blocks += self.pool.alloc(n)
        self._note_blocks("draft", len(self.slots[ix].draft_blocks))
        return True

    def _free_ix(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.state == _FREE:
                return i
        return None

    def _admit(self):
        """Move queued requests into free slots while the first chunk's
        blocks are free. With the radix cache, the effective prompt's
        longest cached prefix is attached and prefill starts after it;
        admission may evict cached blocks but never preempts."""
        while self.queue:
            ix = self._free_ix()
            if ix is None:
                return
            req = self.queue[0]
            eff_prompt = np.concatenate(
                [np.asarray(req.prompt, np.int64).reshape(-1),
                 np.asarray(req.out, np.int64)])
            P = len(eff_prompt)
            shared = self.radix.match(eff_prompt) \
                if self.radix is not None and P > 0 else []
            m = len(shared) * self.block_size
            first_blocks = self._first_alloc_size(P, m)
            while self.radix is not None and first_blocks > self.pool.n_free:
                with self._phase("evict"):
                    evicted = self.radix.evict_one()
                if not evicted:
                    break
            if first_blocks > self.pool.n_free:
                if shared:
                    self.pool.free(shared)   # release the match's references
                return                       # wait for blocks to free up
            self.queue.popleft()
            self._admit_counter += 1
            self.prefill_tokens_shared += m
            if self.radix is not None:
                self.radix.hit_tokens += m
                self.radix.miss_tokens += P - m
            slot = _Slot(req=req, prompt=eff_prompt, prefill_done=m,
                         blocks=list(shared), admit_seq=self._admit_counter)
            if self.ring_len:
                # the ring pool holds every slot's rings: alloc cannot fail
                slot.ring_blocks = self.ring_pool.alloc(self.ring_len)
                slot.ring_abs = C.ring_abs_row(slot.ring_blocks, self.nb_spec)
                if self.spec:
                    slot.draft_ring_blocks = self.ring_pool.alloc(self.ring_len)
                    slot.draft_ring_abs = C.ring_abs_row(slot.draft_ring_blocks,
                                                         self.nb_spec)
                self._note_blocks("ring", self.ring_len)
            if slot.blocks:
                self._note_blocks("target", len(slot.blocks))
            self.slots[ix] = slot
            if self.tracer is not None:
                self.tracer.on_admit(req.uid, shared_tokens=m)
            if self.cfg.has_state:
                C.reset_slot(self.caches, ix)
            if P == 0:
                slot.state = _DECODE         # zero-block request
            elif m >= P:
                slot.state = _DECODE         # full-prefix hit: skip prefill
                slot.pos = P
                slot.next_input = int(eff_prompt[-1])
            elif self.prefill_mode == "whole":
                slot.state = _PREFILL        # visible to _pick_victim
                self._do_whole_prefill(ix)
                if self.slots[ix].req is not req:
                    break                    # admission failed (self-evicted)
            else:
                slot.state = _PREFILL

    def _first_alloc_size(self, P: int, shared: int = 0) -> int:
        """Blocks the first prefill chunk needs beyond ``shared`` attached
        (block-aligned) prompt rows."""
        if P == 0:
            return 1
        if shared >= P:
            return 0
        if self.prefill_mode == "whole":
            return -(-P // self.block_size)
        rows = shared + min(self.chunk_size, P - shared)
        return -(-rows // self.block_size) - shared // self.block_size

    # ---------------- prefill ----------------

    def _do_whole_prefill(self, ix: int):
        s = self.slots[ix]
        P = len(s.prompt)
        need = -(-P // self.block_size) - len(s.blocks)
        if need > 0:
            if not self._make_room(need, ix):
                return
            s.blocks += self.pool.alloc(need)
            self._note_blocks("target", len(s.blocks))
        tr = self.tracer
        t0 = tr.now() if tr is not None else 0.0
        self._prefill_whole_fn(ix, self._tensor(s.prompt)[None])
        if tr is not None:
            tr.on_prefill_chunk(s.req.uid, start=0, rows=P, t0=t0, t1=tr.now())
        self.prefill_tokens_computed += P
        s.state = _DECODE
        s.prefill_done = P
        s.pos = P
        s.next_input = int(s.prompt[-1])

    def _prep_chunk(self, ix: int):
        """Host half of a chunk: bounds, blocks (possibly preempting), the
        padded token row. Returns (tokens (chunk_size,), start, real), or
        None if the slot was evicted while making room. A recurrent model's
        row is exactly the real rows: its state must see the prompt alone."""
        s = self.slots[ix]
        start = s.prefill_done
        real = min(self.chunk_size, len(s.prompt) - start)
        length = real if self.cfg.has_state else self.chunk_size
        # blocks cover real rows only: pad-row writes past the allocated
        # table entries fall into the null block
        need = -(-(start + real) // self.block_size) - len(s.blocks)
        if need > 0:
            if not self._make_room(need, ix):
                return None
            s.blocks += self.pool.alloc(need)
            self._note_blocks("target", len(s.blocks))
        chunk = np.zeros((length,), np.int64)
        chunk[:real] = s.prompt[start:start + real]
        return chunk, start, real

    def _finish_chunk(self, ix: int, real: int):
        """After a chunk ran: index the newly completed full prompt blocks
        in the radix tree; flip to decode when the prompt is in."""
        s = self.slots[ix]
        s.prefill_done += real
        self.prefill_tokens_computed += real
        if self.radix is not None:
            s.radix_node, s.radix_done = self.radix.insert(
                s.prompt[:s.prefill_done], s.blocks, at=s.radix_node,
                done=s.radix_done)
        if s.prefill_done >= len(s.prompt):
            s.state = _DECODE
            s.pos = len(s.prompt)
            s.next_input = int(s.prompt[-1])

    def _do_prefill(self, ixs: list[int]):
        """One chunk over up to prefill_batch prefilling slots, padded to
        prefill_batch rows; a pad row has an all-null table, so its writes
        land in the null block and no live or shared block is touched."""
        preps = []
        for ix in ixs:
            s = self.slots[ix]
            if s.state != _PREFILL:
                continue                      # evicted by an earlier prep
            req = s.req
            prep = self._prep_chunk(ix)
            if prep is not None:
                preps.append((ix, req, prep))
        # a later slot's _make_room may have preempted an earlier one
        live = [(ix, prep) for ix, req, prep in preps
                if self.slots[ix].state == _PREFILL and self.slots[ix].req is req]
        if not live:
            return
        Bp = self.prefill_batch
        tokens = np.zeros((Bp, len(live[0][1][0])), np.int64)
        starts = np.zeros((Bp,), np.int64)
        tables = np.full((Bp, self.nb_max), C.NULL_BLOCK, np.int64)
        for j, (ix, (chunk, start, _)) in enumerate(live):
            tokens[j] = chunk
            starts[j] = start
            tables[j] = self._table_row(self.slots[ix])
        tr = self.tracer
        t0 = tr.now() if tr is not None else 0.0
        # a recurrent model's exact-length last chunk may be one row, which
        # attends as a decode step does: on a ring, through its absolute table
        one_row = tokens.shape[1] == 1
        self._prefill_fn(self._tensor(tables), self._tensor(tokens),
                         self._tensor(starts),
                         rings=self._ring_tables([(j, ix) for j, (ix, _) in
                                                  enumerate(live)], Bp,
                                                 width=self.nb_max if one_row else None),
                         slot=live[0][0] if self.cfg.has_state else None)
        if tr is not None:
            t1 = tr.now()
            for ix, (_, start, real) in live:
                tr.on_prefill_chunk(self.slots[ix].req.uid, start=start, rows=real,
                                    t0=t0, t1=t1)
        self.prefill_chunks += 1
        for ix, (_, _, real) in live:
            self._finish_chunk(ix, real)

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
                self._note_blocks("target", len(s.blocks))

    def _finish(self, ix: int):
        s = self.slots[ix]
        s.req.done = True
        self._release(s)
        self.slots[ix] = _Slot()
        if self.tracer is not None:
            self.tracer.on_finish(s.req.uid)

    def _emit(self, i: int, tok: int) -> bool:
        """Append one token to slot i's request; True when it is done."""
        s = self.slots[i]
        req = s.req
        req.out.append(tok)
        s.next_input = tok
        s.pos += 1
        done = ((req.eos_id is not None and tok == req.eos_id)
                or len(req.out) >= req.max_new
                or s.pos >= self.max_len - 1)
        if self.tracer is not None:
            self.tracer.on_token(req.uid, tok, done)
        if req.on_token is not None:
            req.on_token(tok, done)
        return done

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
        mask = torch.as_tensor([s.state == _DECODE for s in self.slots],
                               device=self.device) if self.cfg.has_state else None
        logits = self._decode_fn(self._tensor(tables), self._tensor(tokens),
                                 self._tensor(pos),
                                 self._ring_tables([(i, i) for i in active],
                                                   self.n_slots, width=self.nb_max),
                                 mask)
        uids, sidx, temp, topp = self._sampler_rows()
        nxt = S.sample(logits, self.sampler, uids, sidx, temp, topp).tolist()
        self.decode_steps += 1
        self.busy_slot_steps += len(active)
        for i in active:
            if self._emit(i, int(nxt[i])):
                self._finish(i)

    def _sampler_rows(self):
        """(uids, sidx, temperature, top_p) rows: the draw stream of each
        slot's request (uid, tokens generated so far) on the device, and its
        sampler overrides folded over the engine's defaults on the host.
        Free slots get inert values. Non-int uids hash through crc32, so the
        stream id is stable across runs."""
        sc = self.sampler
        uids = np.zeros((self.n_slots,), np.int64)
        sidx = np.zeros((self.n_slots,), np.int64)
        temp = np.full((self.n_slots,), sc.temperature, np.float32)
        topp = np.full((self.n_slots,), sc.top_p, np.float32)
        for i, s in enumerate(self.slots):
            r = s.req
            if r is None:
                continue
            u = r.uid if isinstance(r.uid, int) else zlib.crc32(str(r.uid).encode())
            uids[i] = u & 0x7FFFFFFF
            sidx[i] = len(r.out)
            if r.temperature is not None:
                temp[i] = r.temperature
            if r.top_p is not None:
                topp[i] = r.top_p
        return (self._tensor(uids), self._tensor(sidx), torch.from_numpy(temp),
                torch.from_numpy(topp))

    # ---------------- speculative decode ----------------

    def _fed_stream(self, s: _Slot, upto: int) -> np.ndarray:
        """The first ``upto`` tokens of the slot's fed-token stream, whose
        K/V occupies target rows 0..upto-1: the prompt, the last prompt
        token re-fed at row P, then the tokens generated since admission
        (earlier ones were folded into the prompt by a preemption)."""
        P = len(s.prompt)
        f = list(s.prompt[:min(upto, P)])
        if upto > P:
            f.append(int(s.prompt[-1]) if P else 0)
            gen = s.req.out[len(s.req.out) - (s.pos - P):] if s.pos > P else []
            f.extend(int(t) for t in gen[: upto - P - 1])
        return np.asarray(f, np.int64)

    def _draft_target(self, s: _Slot) -> int:
        """The row the drafter should be caught up to."""
        return s.prefill_done if s.state == _PREFILL else s.pos

    def _do_draft_prefill(self):
        """One batched chunk catching drafter KV up to the target's context
        for up to prefill_batch lagging slots (round-robin); a slot that
        gets no blocks keeps decoding undrafted."""
        lag = [i for i, s in enumerate(self.slots)
               if s.state in (_PREFILL, _DECODE)
               and s.draft_done < self._draft_target(s)]
        if not lag:
            return
        j0 = self._dpf_rr % len(lag)
        self._dpf_rr += 1
        lag = (lag[j0:] + lag[:j0])[:self.prefill_batch]
        Bp = self.prefill_batch
        tokens = np.zeros((Bp, self.chunk_size), np.int64)
        starts = np.zeros((Bp,), np.int64)
        tables = np.full((Bp, self.nb_spec), C.NULL_BLOCK, np.int64)
        live = []
        for j, i in enumerate(lag):
            s = self.slots[i]
            start = s.draft_done
            real = min(self.chunk_size, self._draft_target(s) - start)
            need = -(-(start + real) // self.block_size) - len(s.draft_blocks)
            if need > 0 and not self._alloc_draft(i, need):
                continue                      # the row stays inert
            tokens[j, :real] = self._fed_stream(s, start + real)[start:]
            starts[j] = start
            tables[j] = C.table_row(s.draft_blocks, self.nb_spec)
            live.append((j, i, real))
        if not live:
            return
        self._prefill_fn(self._tensor(tables), self._tensor(tokens),
                         self._tensor(starts), draft=True,
                         rings=self._ring_tables([(j, i) for j, i, _ in live], Bp,
                                                 draft=True))
        self.spec_draft_prefills += 1
        for _, i, real in live:
            self.slots[i].draft_done += real

    def _do_spec_decode(self):
        """One speculative round for the decode batch: the drafter's k+1
        steps, the target's (n_slots, k+1) verify, rejection sampling.
        Slots whose drafter is not synced, or that get no blocks, ride the
        same forwards undrafted and emit one token."""
        k = self.spec_k
        self._grow_for_decode()
        # who drafts: a synced drafter, and target and drafter blocks for
        # rows pos..pos+k
        drafting = np.zeros((self.n_slots,), bool)
        for i in range(self.n_slots):
            s = self.slots[i]
            if s.state != _DECODE or s.draft_done != s.pos:
                continue
            blocks = -(-min(s.pos + k + 1, self.max_len) // self.block_size)
            need = blocks - len(s.blocks)
            if need > 0:
                if not self._make_room(need, i):
                    continue                  # slot i itself was evicted
                s.blocks += self.pool.alloc(need)
                self._note_blocks("target", len(s.blocks))
            dneed = blocks - len(s.draft_blocks)
            if dneed > 0 and not self._alloc_draft(i, dneed):
                continue
            drafting[i] = True
        # _make_room above may have preempted slots marked earlier
        active = [i for i, s in enumerate(self.slots) if s.state == _DECODE]
        for i in range(self.n_slots):
            drafting[i] &= self.slots[i].state == _DECODE
        if not active:
            return
        first = np.zeros((self.n_slots,), np.int64)
        pos = np.zeros((self.n_slots,), np.int64)
        vtables = np.full((self.n_slots, self.nb_spec), C.NULL_BLOCK, np.int64)
        dtables = np.full((self.n_slots, self.nb_spec), C.NULL_BLOCK, np.int64)
        for i in active:
            s = self.slots[i]
            first[i] = s.next_input
            pos[i] = s.pos
            vtables[i] = C.table_row(s.blocks, self.nb_spec)
            if drafting[i]:
                dtables[i] = C.table_row(s.draft_blocks, self.nb_spec)
        rows = self._sampler_rows()
        first_t, pos_t = self._tensor(first), self._tensor(pos)
        # a row that does not draft keeps an all-null drafter ring: its
        # inert writes must not land in a ring a catch-up is still filling
        drafts, p_draft = self._draft_fn(
            self._tensor(dtables), first_t, pos_t, rows,
            self._ring_tables([(i, i) for i in active if drafting[i]], self.n_slots,
                              draft=True, width=self.nb_spec))
        logits = self._verify_fn(self._tensor(vtables),
                                 torch.cat([first_t[:, None], drafts], 1), pos_t,
                                 self._ring_tables([(i, i) for i in active],
                                                   self.n_slots))
        n_acc, toks = self._spec_accept_fn(
            logits, drafts, p_draft,
            torch.as_tensor(drafting, device=self.device), rows)
        n_acc, toks = n_acc.tolist(), toks.tolist()

        self.decode_steps += 1
        self.spec_rounds += 1
        self.busy_slot_steps += len(active)
        for i in active:
            s = self.slots[i]
            req = s.req
            # context room keeps every emitted row inside real blocks
            limit = min(n_acc[i] + 1, (self.max_len - 1) - s.pos,
                        req.max_new - len(req.out))
            emitted, done = 0, False
            for j in range(limit):
                emitted += 1
                done = self._emit(i, int(toks[i][j]))
                if done:
                    break
            self.spec_emitted += emitted
            if drafting[i]:
                self.spec_draft_tokens += k
                self.spec_accepted += min(n_acc[i], emitted)
                # every emitted token below the new pos was fed to the
                # drafter at its row by the k+1 steps
                s.draft_done = s.pos
            if done:
                self._finish(i)

    # ---------------- main loop ----------------

    def step(self) -> int:
        """Admit, run one prefill chunk step, then (spec mode) one drafter
        catch-up chunk, then one batched decode step or speculative round.
        Returns the number of occupied slots. Traced, the step is cut into
        its phases and the pool and queue gauges are sampled at its end."""
        tr = self.tracer
        if tr is not None:
            tr.step_begin(self.steps)
        with self._phase("admit"):
            self._admit()
        prefilling = [i for i, s in enumerate(self.slots) if s.state == _PREFILL]
        if prefilling:
            k = self._pf_rr % len(prefilling)
            self._pf_rr += 1
            with self._phase("prefill"):
                self._do_prefill((prefilling[k:] + prefilling[:k])[:self.prefill_batch])
        if self.spec:
            with self._phase("draft_prefill"):
                self._do_draft_prefill()
        with self._phase("decode"):
            if self.spec:
                self._do_spec_decode()
            else:
                self._do_decode()
        self.steps += 1
        if tr is not None:
            tr.step_end(self._sample_gauges())
        return sum(s.state != _FREE for s in self.slots)

    def run(self, max_steps: int = 10_000) -> dict:
        """Step until the queue and all slots drain (or max_steps)."""
        while (self.queue or any(s.state != _FREE for s in self.slots)) \
                and self.steps < max_steps:
            self.step()
        return self.metrics()

    def reset_prefix_cache(self):
        """Invalidate the radix index (e.g. after swapping params): cached
        blocks no live request holds return to the free list. No-op without
        the cache."""
        if self.radix is not None:
            self.radix.reset()
            for s in self.slots:        # resume hints point into the old tree
                s.radix_node, s.radix_done = None, 0

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

    def _sample_gauges(self, mirror: bool = False) -> dict:
        """The step's gauges: pool occupancy, tree-held blocks, active
        slots, queue depth and the radix hit ratio; ``mirror`` also writes
        them into ``obs`` (done at ``metrics()`` time, not every step)."""
        free = self.pool.n_free
        g = {"free_blocks": free,
             "used_blocks": self.n_blocks - 1 - free,
             "tree_blocks": self.radix.n_nodes if self.radix is not None else 0,
             "active_slots": sum(s.state != _FREE for s in self.slots),
             "queue_depth": len(self.queue),
             "radix_hit_ratio": None}
        if self.radix is not None:
            seen = self.radix.hit_tokens + self.radix.miss_tokens
            if seen:
                g["radix_hit_ratio"] = self.radix.hit_tokens / seen
        if mirror:
            for k, v in g.items():
                if v is not None:
                    self.obs.set_gauge(k, v)
        return g

    def metrics(self) -> dict:
        util = self.busy_slot_steps / max(self.decode_steps * self.n_slots, 1)
        self._sample_gauges(mirror=True)
        out = {
            "steps": self.decode_steps,
            "engine_steps": self.steps,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_tokens_shared": self.prefill_tokens_shared,
            "preemptions": self.preemptions,
            "rejections": self.rejections,
            "slot_utilization": util,
            "prefix_cache": self.radix.metrics() if self.radix is not None else None,
            # the high-water blocks of one request by kind (also the gauge
            # pool_blocks_peak{kind}): a ring engine's ring peak is flat
            "pool_blocks_peak": dict(self._peaks),
            "spec": None if not self.spec else {
                "rounds": self.spec_rounds,
                "draft_tokens": self.spec_draft_tokens,
                "accepted": self.spec_accepted,
                "emitted": self.spec_emitted,
                "acceptance_rate": self.spec_accepted / max(self.spec_draft_tokens, 1),
                # per slot-step (1.0 == plain decode; up to spec_k+1)
                "accepted_tokens_per_step": (self.spec_emitted
                                             / max(self.busy_slot_steps, 1)),
                "draft_evictions": self.spec_draft_evictions,
                "draft_prefill_chunks": self.spec_draft_prefills,
            },
            "metrics": self.obs.snapshot(),
        }
        if self.tracer is not None:
            out["latency"] = self.tracer.latency_summary()
            out["phases"] = self.tracer.phase_summary()
        return out
