"""The port's paged-engine serving features against the JAX reference's
Engine: the prefix-sharing radix cache, batched prefill chunks,
whole-prompt admission and ``ContinuousBatcher``, self-speculative
decoding with a w2a2 drafter, and seeded sampling.

Weights are the reference's, carried across with the bridge
(``test_torch_engine._setup``: the float32 reduced qwen1.5-0.5b, two
layers, int8 pool). Prompts share a 16-token prefix (two blocks of 8).
Greedy tokens are compared under ``test_torch_engine._same_or_near_tie``:
where they differ, the reference's top-2 logit margin at the first
diverging step must be below its MARGIN_TOL. Spec mode is held against the
reference's non-spec greedy run: the port attends through another float
formulation at S = k+1 (verify) than at S = 1 (decode), so it may pick the
other token at a near tie (the module docstring of serving/engine.py).
Counters that the host scheduler decides (prefill tokens computed and
shared, preemptions) must equal the reference's. Plus the radix cache and
``BlockPool.ref`` unit cases of tests/test_radix.py and one gloo
``--tp 2`` case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import Engine as JEngine, Request as JRequest
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.launch import mesh
from repro_torch.serving import (BlockPool, ContinuousBatcher, Engine, RadixCache,
                                 Request, SamplerConfig)
from repro_torch.serving.cache import NULL_BLOCK

import test_torch_engine as te

PREFIX = 16
SUFFIX_LENS = (3, 9, 14, 5)
MAX_NEW = 6
KW = te.ENGINE_KW                       # n_slots 2, max_len 64, block 8, chunk 16


def _prompts(vocab: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=PREFIX)
    return [np.concatenate([prefix, rng.integers(0, vocab, size=n)]).astype(np.int32)
            for n in SUFFIX_LENS]


def _trees():
    """(reference cfg, port cfg, reference tree, port tree) of the w2a16
    target, the same of the w2a2 drafter (the same weights), and prompts."""
    jc, tc, qp, tq, _ = te._setup("w2a16", "int8")
    djc, dtc, dqp, dtq, _ = te._setup("w2a2", "int8")
    return (jc, tc, qp, tq), (djc, dtc, dqp, dtq), _prompts(jc.vocab_size)


_REF = {}


def _ref(name: str, make, prompts, *, margins_from="sample"):
    """A reference run (cached by name): tokens, the top-2 margin of every
    emitted token's logits by (uid, step), and the engine."""
    if name not in _REF:
        eng = make()
        margins = {}
        core = getattr(eng, "engine", eng)
        if margins_from == "sample":
            def greedy(logits, *_):
                lg = np.asarray(logits)
                for i, s in enumerate(core.slots):
                    if s.state == jengine._DECODE:
                        top = np.sort(lg[i])[-2:]
                        margins[(s.req.uid, len(s.req.out))] = float(top[1] - top[0])
                return jnp.argmax(logits, axis=-1)
            core._sample = greedy
        else:                                   # spec: the verify's logits
            inner = core._spec_accept

            def accept(logits, *a):
                lg = np.asarray(logits)
                for i, s in enumerate(core.slots):
                    if s.state == jengine._DECODE:
                        for j in range(lg.shape[1]):
                            top = np.sort(lg[i, j])[-2:]
                            margins[(s.req.uid, len(s.req.out) + j)] = \
                                float(top[1] - top[0])
                return inner(logits, *a)
            core._spec_accept = accept
        reqs = [JRequest(uid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
        for r in reqs:
            assert eng.submit(r)
        eng.run()
        assert all(r.done for r in reqs)
        _REF[name] = ([r.out for r in reqs], margins, core)
    return _REF[name]


def _ref_greedy():
    """The reference's chunked greedy run, with its radix cache on: its
    tokens are those of its run without the cache (a matched block holds
    the bytes prefilling its tokens writes), and one run serves both."""
    (jc, _, qp, _), _, prompts = _trees()
    return _ref("greedy", lambda: JEngine(jc, qp, prefix_cache=True, **KW), prompts)


def _port(tq_cfg, prompts, **kw):
    tc, tq = tq_cfg
    eng = Engine(tc, tq, **{**KW, **kw})
    reqs = [Request(uid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    m = eng.run()
    assert all(r.done for r in reqs)
    assert eng.pool.n_free == eng.n_blocks - 1 - (m["prefix_cache"] or {}).get(
        "cached_blocks", 0)                     # only the tree holds blocks
    return [r.out for r in reqs], m, eng


def _dispatches(m) -> dict:
    out = {}
    for k, v in m["metrics"]["counters"].items():
        if k.startswith("kernel_dispatch_total{"):
            op = k.split("op=")[1].split(",")[0].rstrip("}")
            out[op] = out.get(op, 0) + int(v)
    return out


# --------------------------------------------------------------------------- #
# RadixCache and BlockPool.ref (tests/test_radix.py:67-140)
# --------------------------------------------------------------------------- #

def test_radix_match_insert_refcounts():
    pool = BlockPool(10)
    rc = RadixCache(pool, block_size=4)
    toks = np.arange(11, dtype=np.int32)
    blocks = pool.alloc(3)
    rc.insert(toks, blocks)
    assert rc.n_cached_blocks == 2
    assert pool.refcount(blocks[0]) == 2 and pool.refcount(blocks[2]) == 1
    got = rc.match(toks)
    assert got == blocks[:2] and pool.refcount(blocks[0]) == 3
    pool.free(got)
    other = np.concatenate([toks[:8], np.asarray([99, 98, 97, 96], np.int32)])
    got = rc.match(other)
    assert got == blocks[:2]
    pool.free(got)
    assert rc.match(np.asarray([7, 7, 7, 7], np.int32)) == []


def test_radix_lru_eviction_leaf_first():
    pool = BlockPool(10)
    rc = RadixCache(pool, block_size=2)
    a = pool.alloc(2)
    rc.insert(np.asarray([1, 2, 3, 4], np.int32), a)
    pool.free(a)
    free0 = pool.n_free
    assert rc.evict_one() and rc.n_cached_blocks == 1
    assert rc.match(np.asarray([1, 2], np.int32)) == [a[0]]
    pool.free([a[0]])
    assert rc.evict_one() and not rc.evict_one()
    assert pool.n_free == free0 + 2 and rc.evictions == 2


def test_radix_never_evicts_referenced_blocks():
    pool = BlockPool(6)
    rc = RadixCache(pool, block_size=2)
    a = pool.alloc(1)
    rc.insert(np.asarray([5, 6], np.int32), a)
    assert not rc.evict_one()
    pool.free(a)
    assert rc.evict_one()


def test_radix_reset_releases_only_tree_refs():
    pool = BlockPool(8)
    rc = RadixCache(pool, block_size=2)
    a = pool.alloc(2)
    rc.insert(np.asarray([1, 2, 3, 4], np.int32), a)
    rc.reset()
    assert rc.n_cached_blocks == 0 and pool.refcount(a[0]) == 1
    pool.free(a)
    assert pool.n_free == 7


def test_radix_insert_hint_survives_eviction_of_another_requests_copy():
    # two requests with one prompt, admitted together, both miss: B's first
    # insert finds A's nodes. A ends and the pool evicts them; B's next
    # insert must not hang its nodes under the evicted ones, or their
    # blocks outlive reset() and never return to the pool.
    pool = BlockPool(8)
    rc = RadixCache(pool, block_size=2)
    toks = np.arange(6, dtype=np.int32)
    a, b = pool.alloc(2), pool.alloc(3)
    rc.insert(toks[:4], a)
    hint, done = rc.insert(toks[:4], b[:2])
    pool.free(a)
    assert rc.evict_one() and rc.evict_one() and rc.n_cached_blocks == 0
    rc.insert(toks, b, at=hint, done=done)
    assert rc.n_cached_blocks == 3
    assert rc.match(toks) == b
    pool.free(b)
    pool.free(b)
    rc.reset()
    assert rc.n_cached_blocks == 0 and pool.n_free == 7


def test_block_pool_double_free_and_ref_of_a_free_block_raise():
    pool = BlockPool(4)
    a = pool.alloc(2)
    pool.ref(a[:1])
    pool.free(a)
    pool.free(a[:1])
    with pytest.raises(RuntimeError, match="double free"):
        pool.free(a[:1])
    with pytest.raises(RuntimeError, match="unallocated"):
        pool.ref(a[1:])


# --------------------------------------------------------------------------- #
# Prefix cache, batched prefill, whole-prompt admission
# --------------------------------------------------------------------------- #

def test_prefix_cache_matches_reference_tokens_and_counters():
    (_, tc, _, tq), _, prompts = _trees()
    want, margins, jeng = _ref_greedy()
    got, m, eng = _port((tc, tq), prompts, prefix_cache=True)
    te._same_or_near_tie(want, got, margins)
    assert m["prefill_tokens_shared"] == jeng.prefill_tokens_shared > 0
    assert m["prefill_tokens_computed"] == jeng.prefill_tokens_computed
    assert m["prefix_cache"] == jeng.radix.metrics()
    # a matched block holds the bytes prefilling its tokens writes
    plain, m0, _ = _port((tc, tq), prompts)
    assert plain == got
    assert m0["prefill_tokens_computed"] - m["prefill_tokens_computed"] \
        == m["prefill_tokens_shared"]
    snap = m["metrics"]
    assert snap["counters"]["engine_prefill_tokens_shared"] == m["prefill_tokens_shared"]
    assert snap["gauges"]["tree_blocks"] == m["prefix_cache"]["cached_blocks"]
    eng.reset_prefix_cache()
    assert eng.pool.n_free == eng.n_blocks - 1 and eng.radix.n_cached_blocks == 0


def test_full_prefix_hit_skips_prefill_and_refeeds_the_last_token():
    """A prompt of whole blocks served twice: the second admission attaches
    every block, runs no prefill chunk and decodes from pos = P, re-feeding
    the last prompt token, so its tokens equal the first's."""
    (_, tc, _, tq), _, prompts = _trees()
    p = prompts[1][:24]
    eng = Engine(tc, tq, prefix_cache=True, **KW)
    outs = []
    for uid in (0, 1):
        r = Request(uid=uid, prompt=p, max_new=MAX_NEW)
        assert eng.submit(r)
        chunks = eng.prefill_chunks
        eng.run()
        outs.append((r.out, eng.prefill_chunks - chunks))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == 2 and outs[1][1] == 0
    assert eng.prefill_tokens_shared == 24


def test_shared_blocks_survive_other_requests_padded_prefill():
    """Another request's chunk, pad rows included, writes no shared block;
    the null block is in no live table."""
    (_, tc, _, tq), _, prompts = _trees()
    eng = Engine(tc, tq, **{**KW, "n_slots": 1}, prefix_cache=True)
    assert eng.submit(Request(uid=0, prompt=prompts[0], max_new=2))
    eng.run()
    shared = eng.radix.match(prompts[0][:PREFIX])
    assert len(shared) == 2
    before = [{k: v[shared].clone() for k, v in layer.items()} for layer in eng.caches]
    p2 = np.random.default_rng(12).integers(0, tc.vocab_size, size=21)
    assert eng.submit(Request(uid=1, prompt=p2, max_new=2))
    eng.run()
    for layer, b in zip(eng.caches, before):
        for k, v in b.items():
            assert torch.equal(layer[k][shared], v)
    assert all(NULL_BLOCK not in s.blocks for s in eng.slots)
    eng.pool.free(shared)


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_batched_prefill_matches_reference_and_one_row_chunks(prefix_cache):
    (_, tc, _, tq), _, prompts = _trees()
    want, margins, _ = _ref_greedy()
    one, m1, _ = _port((tc, tq), prompts, prefix_cache=prefix_cache)
    got, m2, eng = _port((tc, tq), prompts, prefill_batch=2, prefix_cache=prefix_cache)
    assert eng.prefill_batch == 2
    te._same_or_near_tie(want, got, margins)
    assert got == one                           # pad rows are inert
    assert m2["prefill_chunks"] < m1["prefill_chunks"]
    assert Engine(tc, tq, prefill_batch=9, **KW).prefill_batch == KW["n_slots"]


def test_whole_prompt_admission_and_continuous_batcher_match_reference():
    (jc, tc, qp, tq), _, prompts = _trees()
    want, margins, jeng = _ref("whole", lambda: JEngine(jc, qp, prefill="whole", **KW),
                               prompts)
    got, m, eng = _port((tc, tq), prompts, prefill="whole", prefix_cache=True,
                        prefill_batch=2)
    assert eng.radix is None and eng.prefill_batch == 1
    te._same_or_near_tie(want, got, margins)
    assert (m["prefill_chunks"], m["prefill_tokens_computed"], m["decode_steps"]) == \
        (0, jeng.prefill_tokens_computed, jeng.decode_steps)
    # the batcher is whole-prompt admission on 16-row blocks: the same
    # gathered 64-row view, so the reference's whole run is its oracle
    b = ContinuousBatcher(tc, tq, n_slots=2, max_len=64)
    assert b.engine.prefill_mode == "whole" and b.engine.block_size == 16
    reqs = [Request(uid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        assert b.submit(r)
    b.run()
    te._same_or_near_tie(want, [r.out for r in reqs], margins)
    assert b.steps == b.engine.decode_steps > 0 and not b.queue


# --------------------------------------------------------------------------- #
# Speculative decoding
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("drafter,spec_k", [("w2a2", 1), ("w2a2", 4), ("self", 4)])
def test_spec_decoding_matches_reference_greedy(drafter, spec_k):
    """A w2a2 drafter of this random two-layer model proposes tokens the
    w2a16 target rejects; a drafter that is the target itself has its
    drafts accepted, which drives the multi-token rounds."""
    (_, tc, _, tq), (_, dtc, _, dtq), prompts = _trees()
    if drafter == "self":
        dtc, dtq = tc, tq
    want, margins, _ = _ref_greedy()
    got, m, eng = _port((tc, tq), prompts, spec_draft_params=dtq,
                        spec_draft_cfg=dtc, spec_k=spec_k)
    te._same_or_near_tie(want, got, margins)
    sp = m["spec"]
    assert sp["emitted"] == sum(map(len, got)) and m["decode_steps"] == sp["rounds"]
    assert 0 <= sp["accepted"] <= sp["draft_tokens"]
    if drafter == "self":
        assert sp["acceptance_rate"] > 0.5 and sp["accepted_tokens_per_step"] > 2
    # launches: the drafter runs k+1 one-token forwards a round and its
    # catch-up chunks, the target its prefill chunks and one verify a round
    L, R = tc.n_layers, sp["rounds"]
    draft_fw = (spec_k + 1) * R + sp["draft_prefill_chunks"]
    target_fw = m["prefill_chunks"] + R
    want_ops = {"paged_attention": L * (spec_k + 1) * R}
    for op, fw in (("lut_gemm" if drafter == "w2a2" else "dequant_matmul", draft_fw),
                   ("dequant_matmul", target_fw)):
        want_ops[op] = want_ops.get(op, 0) + 7 * L * fw
    assert _dispatches(m) == want_ops


def test_spec_decoding_under_preemption_matches_reference():
    (jc, tc, qp, tq), (djc, dtc, dqp, dtq), prompts = _trees()
    kw = dict(n_blocks=9, spec_k=3)
    want, margins, jeng = _ref(
        "spec_small", lambda: JEngine(jc, qp, spec_draft_params=dqp,
                                      spec_draft_cfg=djc, **kw, **KW),
        prompts, margins_from="spec")
    got, m, _ = _port((tc, tq), prompts, spec_draft_params=dtq, spec_draft_cfg=dtc,
                      **kw)
    assert m["preemptions"] == jeng.preemptions > 0
    assert m["spec"]["draft_evictions"] == jeng.spec_draft_evictions
    te._same_or_near_tie(want, got, margins)


def test_spec_refuses_whole_prefill_and_tensor_parallelism():
    (_, tc, _, tq), (_, dtc, _, dtq), _ = _trees()
    with pytest.raises(ValueError, match="chunked"):
        Engine(tc, tq, prefill="whole", spec_draft_params=dtq, **KW)
    with pytest.raises(NotImplementedError, match="item 11"):
        Engine(tc, tq, spec_draft_params=dtq, tp_group=object(), **KW)


# --------------------------------------------------------------------------- #
# Seeded sampling
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("spec", [False, True])
def test_top_k_1_sampling_gives_reference_greedy_tokens(spec):
    (_, tc, _, tq), (_, dtc, _, dtq), prompts = _trees()
    want, margins, _ = _ref_greedy()
    kw = dict(spec_draft_params=dtq, spec_draft_cfg=dtc) if spec else {}
    got, _, _ = _port((tc, tq), prompts, sampler=SamplerConfig(temperature=0.7, top_k=1),
                      **kw)
    te._same_or_near_tie(want, got, margins)


@pytest.mark.parametrize("spec", [False, True])
def test_seeded_sampling_reproducible_across_runs_and_prefill_batch(spec):
    (_, tc, _, tq), (_, dtc, _, dtq), prompts = _trees()
    kw = dict(spec_draft_params=dtq, spec_draft_cfg=dtc) if spec else {}
    sc = SamplerConfig(temperature=0.8, top_k=50, top_p=0.9, seed=0)
    a, _, _ = _port((tc, tq), prompts, sampler=sc, **kw)
    b, _, _ = _port((tc, tq), prompts, sampler=sc, **kw)
    c, _, _ = _port((tc, tq), prompts, sampler=sc, prefill_batch=2, **kw)
    assert a == b == c
    if not spec:
        greedy, _, _ = _port((tc, tq), prompts)
        other, _, _ = _port((tc, tq), prompts, sampler=SamplerConfig(
            temperature=0.8, top_k=50, top_p=0.9, seed=1))
        assert a != greedy and other != a


def test_per_request_temperature_override_decodes_greedily():
    (_, tc, _, tq), _, prompts = _trees()
    greedy, _, _ = _port((tc, tq), prompts)
    eng = Engine(tc, tq, sampler=SamplerConfig(temperature=1.0, seed=0), **KW)
    reqs = [Request(uid=i, prompt=p, max_new=MAX_NEW, temperature=0.0 if i % 2 else None)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert [r.out for r in reqs][1::2] == greedy[1::2]


# --------------------------------------------------------------------------- #
# Tensor parallelism
# --------------------------------------------------------------------------- #

def test_tp2_prefix_cache_and_batched_prefill_give_the_tp1_tokens():
    import test_torch_tp as tt
    _, tc, _, qp, _ = tt._tree("w2a8_bs")
    prompts = _prompts(tc.vocab_size, seed=4)
    kw = {**KW, "prefix_cache": True, "prefill_batch": 2}
    res = mesh.run_ranks(mesh.engine_rank, 2,
                         [(tt._jax_free(qp), tc, prompts, MAX_NEW, kw)], device="cpu")[0]
    one, m, _ = _port((tc, bridge.qparams_from_jax(qp, tc, device="cpu")), prompts,
                      prefix_cache=True, prefill_batch=2)
    assert res["tokens"] == one
    assert (res["decode_steps"], res["prefill_chunks"]) == (m["decode_steps"],
                                                            m["prefill_chunks"])
    assert m["prefill_tokens_shared"] > 0
