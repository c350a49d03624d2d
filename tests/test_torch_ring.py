"""Ring-paged local layers (``Engine(ring=True)``, ``--ring``) against the
JAX reference's ring engine, on the reference's reduced gemma3-12b (5
local layers of window 16, 1 global) and h2o-danube-3-4b (one local
layer), float32, int8 pool, max_len 64, blocks of 8, chunks of 16, the
weights carried across with the bridge: greedy tokens and ``ring_len``
under chunked prefill, whole-prompt prefill, spec mode with a w2a2
drafter and preemption; the ring peak flat in the context while the
target's grows; the refusals. Then the port's ring engine against its own
engine without a ring (identical tokens), the ring under ``--tp 2`` (two
gloo ranks), and rows 5 and 6 (the plain versions and the kernels' torch
walk) on a ring spelled out as an absolute table against a full table
that holds the same rows, bit for bit, at lengths that wrap the ring
several times.

Tokens are compared exactly: a local layer's ring holds the rows its
window reads, so the ring changes which rows are gathered, never which
are attended; against the engine without a ring the logits are compared
bit for bit too.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import qplan as jqplan
from repro.models import lm as jlm
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch import bridge
from repro_torch.core import qplan
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch import mesh
from repro_torch.serving import Engine, Request
from repro_torch.serving import cache as C

import test_torch_local as tl
import test_torch_tp as tt

KW = tl.ENGINE_KW                   # n_slots 2, max_len 64, block 8, chunk 16
ARCHS = tl.ARCHS


def _drafter(arch):
    """The w2a2 drafter of ``arch``'s weights: (reference cfg, tree), (port
    cfg, tree)."""
    jc, tc, params, _, _ = tl._setup(arch)
    djc = dataclasses.replace(jc, quant=jqplan.make_plan(w_bits=2, a_bits=2,
                                                         backend="ref"))
    dtc = dataclasses.replace(tc, quant=qplan.make_plan(w_bits=2, a_bits=2))
    dqp = jlm.quantize_tree(params, djc)
    return (djc, dqp), (dtc, bridge.qparams_from_jax(jax.tree.map(np.asarray, dqp),
                                                     dtc, device="cpu"))


def _run_ref(jc, qp, prompts, **kw):
    eng = JEngine(jc, qp, **{**KW, **kw})
    reqs = [JRequest(uid=i, prompt=p, max_new=tl.MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    m = eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs], m, eng


def _run_port(tc, tq, prompts, **kw):
    """The port's engine over ``prompts``: tokens, metrics, the engine, and
    the logits of every decode step and verify (in ``m["logits"]``)."""
    eng = Engine(tc, tq, **{**KW, **kw})
    logits = []
    for name in ("_decode_fn", "_verify_fn"):
        inner = getattr(eng, name)

        def keep(*a, inner=inner):
            lg = inner(*a)
            logits.append(lg.clone())
            return lg

        setattr(eng, name, keep)
    reqs = [Request(uid=i, prompt=p, max_new=tl.MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    m = eng.run()
    m["logits"] = logits
    assert all(r.done for r in reqs)
    assert eng.pool.n_free == eng.n_blocks - 1
    if eng.ring_len:
        assert eng.ring_pool.n_free == eng.n_ring_blocks - 1
    return [r.out for r in reqs], m, eng


CASES = [("gemma3-12b", "chunked", {}),
         ("h2o-danube-3-4b", "chunked", {}),
         ("h2o-danube-3-4b", "preemption", dict(n_blocks=7)),
         ("h2o-danube-3-4b", "whole", dict(prefill="whole")),
         ("h2o-danube-3-4b", "spec", dict(spec_k=2))]


@pytest.mark.parametrize("arch,mode,kw", CASES, ids=[f"{a}-{m}" for a, m, _ in CASES])
def test_ring_engine_matches_reference(arch, mode, kw):
    """The same prompts (three past the window) through both ring engines:
    identical greedy tokens, the same ring_len and ring pool, every local
    layer's pool of n_ring_blocks and the global layer's of n_blocks."""
    jc, tc, _, qp, tq = tl._setup(arch)
    prompts = tl._prompts(jc)
    jkw, tkw = dict(kw), dict(kw)
    if mode == "spec":
        (djc, dqp), (dtc, dtq) = _drafter(arch)
        jkw.update(spec_draft_params=dqp, spec_draft_cfg=djc)
        tkw.update(spec_draft_params=dtq, spec_draft_cfg=dtc)
    want, jm, jeng = _run_ref(jc, qp, prompts, ring=True, **jkw)
    got, m, eng = _run_port(tc, tq, prompts, ring=True, **tkw)
    assert got == want
    assert (eng.ring_len, eng.n_ring_blocks) == (jeng.ring_len, jeng.n_ring_blocks)
    assert m["pool_blocks_peak"] == jm["pool_blocks_peak"]
    assert m["metrics"]["gauges"]["pool_blocks_peak{kind=ring}"] == eng.ring_len
    for t, pool in zip(tc.layer_types(), eng.caches):
        assert pool["k"].shape[0] == (eng.n_ring_blocks if t == "local" else eng.n_blocks)
    if mode == "preemption":
        assert m["preemptions"] == jm["preemptions"] > 0
    if mode == "whole":
        assert eng.ring_len == -(-tc.window // KW["block_size"])
    if mode == "spec":
        assert m["spec"]["rounds"] == jm["spec"]["rounds"]
        assert eng.ring_len == -(-(tc.window + KW["chunk_size"] - 1) // KW["block_size"])


MODES = {"chunked": {}, "whole": dict(prefill="whole"), "prefill_batch 2":
         dict(prefill_batch=2), "kv_splits 3": dict(kv_splits=3),
         "preemption": dict(n_blocks=7), "spec self-drafter": "spec"}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", list(MODES))
def test_ring_engine_gives_its_full_table_engines_tokens(arch, mode):
    """The port's ring engine against its own engine without a ring, in
    every mode: identical greedy tokens, the same counters, and every
    decode step's and verify's logits bit for bit (a chunk attends over
    the ring in the gathered path's key chunks, a decode step through the
    same ops on the ring's absolute table)."""
    _, tc, _, _, tq = tl._setup(arch)
    prompts = tl._prompts(tl._setup(arch)[0])
    kw = MODES[mode]
    if kw == "spec":
        kw = dict(spec_draft_params=tq, spec_draft_cfg=tc, spec_k=3)
    base, mb, _ = _run_port(tc, tq, prompts, **kw)
    ring, mr, eng = _run_port(tc, tq, prompts, ring=True, **kw)
    assert ring == base
    assert len(mr["logits"]) == len(mb["logits"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(mr["logits"], mb["logits"]))
    keys = ("decode_steps", "prefill_chunks", "preemptions", "prefill_tokens_computed")
    assert {k: mr[k] for k in keys} == {k: mb[k] for k in keys}
    assert mr["pool_blocks_peak"]["ring"] == eng.ring_len


def test_ring_peak_is_flat_in_the_context():
    """pool_blocks_peak{kind=ring} is ring_len for a short and a long
    context, while the target's peak grows with the context."""
    jc, tc, _, _, tq = tl._setup("gemma3-12b")
    rng = np.random.default_rng(5)
    peaks = []
    for n in (6, 48):
        _, m, eng = _run_port(tc, tq, [rng.integers(0, jc.vocab_size, n)], ring=True)
        peaks.append(m["pool_blocks_peak"])
        assert m["metrics"]["gauges"]["pool_blocks_peak{kind=ring}"] == eng.ring_len
    assert peaks[0]["ring"] == peaks[1]["ring"] == eng.ring_len
    assert peaks[1]["target"] > peaks[0]["target"]


def test_ring_refusals_match_the_reference():
    """ring=True with prefix_cache, and on an arch without local layers,
    refused with the reference's words (the check runs before the weights
    are read)."""
    jc, tc, *_ = tl._setup("gemma3-12b")
    for make, c in ((JEngine, jc), (Engine, tc)):
        with pytest.raises(ValueError, match="incompatible with prefix_cache"):
            make(c, None, **KW, ring=True, prefix_cache=True)
        with pytest.raises(ValueError, match="requires local attention layers"):
            make(dataclasses.replace(c, pattern=("global",)), None, **KW, ring=True)


def test_ring_under_tensor_parallelism_gives_the_full_table_tokens():
    """Two gloo ranks, each with the whole pool and host-side rings: the
    ring engine's tokens, counters and decode logits are the engine's
    without a ring."""
    jc, tc, params, _, _ = tl._setup("h2o-danube-3-4b")
    tree = tt._jax_free(jax.tree.map(np.asarray, jlm.quantize_tree(params, jc, tp=2)))
    prompts = tl._prompts(jc)
    base, ring = mesh.run_ranks(
        mesh.engine_rank, 2, [(tree, tc, prompts, tl.MAX_NEW, KW),
                              (tree, tc, prompts, tl.MAX_NEW, {**KW, "ring": True})],
        device="cpu")
    assert ring["tokens"] == base["tokens"]
    assert torch.equal(torch.as_tensor(ring["logits"]), torch.as_tensor(base["logits"]))
    assert (ring["decode_steps"], ring["prefill_chunks"]) == \
        (base["decode_steps"], base["prefill_chunks"])


def _ring_operands(rng, *, B, KV, G, hd, bits, bs, lengths, window, ring_len):
    """A full pool and table, and a ring pool (garbage wherever the rows of
    [lengths[b] - window, lengths[b]) do not land) with its absolute table
    (``C.ring_abs_row``) of the same width, holding the same live rows."""
    nb = max(-(-n // bs) for n in lengths) + 1
    shape = (1 + B * nb, bs, KV, hd * bits // 8)

    def codes(n):
        if bits == 8:
            return torch.from_numpy(rng.integers(-127, 128, size=(n,) + shape[1:])
                                    .astype(np.int8))
        return torch.from_numpy(rng.integers(0, 256, size=(n,) + shape[1:])
                                .astype(np.uint8))

    def scales(n):
        return torch.from_numpy(rng.uniform(0.005, 0.05, size=(n,) + shape[1:3])
                                .astype(np.float32))

    full = [codes(shape[0]), scales(shape[0]), codes(shape[0]), scales(shape[0])]
    tables = torch.from_numpy(rng.permutation(np.arange(1, shape[0]))
                              .reshape(B, nb).astype(np.int64))
    n_ring = 1 + B * ring_len
    ring_pool = [codes(n_ring), scales(n_ring), codes(n_ring), scales(n_ring)]
    rings = rng.permutation(np.arange(1, n_ring)).reshape(B, ring_len)
    absolute = torch.from_numpy(np.stack([C.ring_abs_row(list(r), nb) for r in rings]))
    for b, n in enumerate(lengths):
        t = torch.arange(max(0, n - (window or n)), n)
        src = tables[b, t // bs], t % bs
        dst = absolute[b, t // bs], t % bs
        for f, r in zip(full, ring_pool):
            r[dst] = f[src]
    q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32))
    lens = torch.tensor(lengths, dtype=torch.int64)
    k, ks, v, vs = full
    rk, rks, rv, rvs = ring_pool
    return (q, k, ks, v, vs, tables, lens), (q, rk, rks, rv, rvs, absolute, lens)


@pytest.mark.parametrize("hd,bits", [(64, 8), (120, 8), (256, 4)])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("kv_splits", [1, 3])
def test_rows_5_and_6_on_a_ring_are_bitwise_the_full_table(hd, bits, window, kv_splits):
    """The walk and the plain versions of rows 5 and 6 read only rows
    [lengths - window, lengths): on a ring of ceil((window + 31) / 16)
    blocks spelled out as an absolute table of the full table's width, at
    lengths that wrap it several times, they give the full table's output
    bit for bit. Without a window the ring is the whole table (every row
    live), in another block order."""
    rng = np.random.default_rng(hd + bits + (window or 0) + kv_splits)
    lengths = (300, 61, 17) if window else (130, 61, 17)
    bs = 16
    ring_len = -(-(window + 31) // bs) if window else max(-(-n // bs) for n in lengths) + 1
    full, ring = _ring_operands(rng, B=3, KV=2, G=2, hd=hd, bits=bits, bs=bs,
                                lengths=lengths, window=window, ring_len=ring_len)
    assert window is None or lengths[0] > 3 * ring_len * bs
    fns = [lambda *o: PA.paged_attention_walk(*o, bits=bits, kv_splits=kv_splits,
                                              window=window)]
    if kv_splits == 1:
        fns.append(lambda *o: PA.paged_attention_plain(*o, bits=bits, window=window))
    else:
        fns.append(lambda *o: PA.paged_attention_splitkv_plain(
            *o, bits=bits, kv_splits=kv_splits, window=window))
    for fn in fns:
        assert torch.equal(fn(*ring), fn(*full))
