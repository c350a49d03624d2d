"""The recurrent slice on the card: the decode-attention kernels at
recurrentgemma-9b's multi-query head (KV 1, G 16, hd 256, window 2048),
rows 5 (``paged_attention``) and 9 (``kv_cache_attention``), against their
plain PyTorch versions; and the reduced recurrentgemma, with its local
layer widened to that head, through the paged engine and the fixed loop
against its plain-GEMM runs. Every test is marked ``gpu`` and skips, from
a fixture, without a card. Run on the H100 with ``PYTHONPATH=src python -m
pytest -q -m gpu tests/test_torch_recurrent_gpu.py``. This file imports no
jax.

Tolerances: ``paged_attention`` within 1e-5 of max|plain| plus 1e-6
absolute (f32 sums and exponentials in another order than the plain
version's dense masked softmax); ``kv_cache_attention`` bit for bit
against its plain version, the replay of its walk; the w2a2 runs' tokens
and first-step logits bit for bit against the plain-GEMM runs
(``lut_gemm`` with an integer table sums exact integers).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import qplan
from repro_torch.kernels import kv_cache_attention as KA
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.serving import Engine, Request

RTOL = 1e-5
ATOL = 1e-6
KV, G, HD, WINDOW = 1, 16, 256, 2048


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


def _codes(rng, shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


def _close(got, want):
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0,
                               atol=ATOL + RTOL * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("lengths,bs,window", [
    ((40, 2100), 16, WINDOW),              # inside the window, past it
    ((8192, 5000, 2049, 1), 512, WINDOW),  # B 4, 512-row blocks
    ((300, 77), 16, None),                 # no window
])
def test_paged_attention_g16_matches_plain(cuda, lengths, bs, window):
    """Row 5 at G 16 (one launch a layer) against its plain version, int8,
    q in bf16 and f32."""
    rng = np.random.default_rng(len(lengths) + bs)
    B = len(lengths)
    need = [-(-n // bs) for n in lengths]
    nb = max(need) + 1
    n_blocks = 1 + sum(need)
    ids = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, nb), np.int64)
    o = 0
    for b, k in enumerate(need):
        tables[b, :k] = ids[o:o + k]
        o += k
    shape = (n_blocks, bs, KV, HD)
    ops = [torch.from_numpy(x).to(cuda) for x in (
        rng.normal(size=(B, KV, G, HD)).astype(np.float32), _codes(rng, shape),
        rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32), _codes(rng, shape),
        rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32), tables,
        np.asarray(lengths, np.int64))]
    for q in (ops[0], ops[0].bfloat16()):
        want = PA.paged_attention_plain(q, *ops[1:], bits=8, window=window)
        before = PA.paged_attention_cuda.launches
        got = PA.paged_attention_cuda(q, *ops[1:], bits=8, window=window)
        assert PA.paged_attention_cuda.launches == before + 1
        _close(got, want)
    with pytest.raises(NotImplementedError, match="future work"):
        PA.paged_attention_splitkv_cuda(*ops, bits=8, kv_splits=4, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,lengths", [(2, WINDOW, (WINDOW, 700)),
                                         (4, 8192 + 16, (8200, 8192, 33, 4000))])
def test_kv_cache_attention_g16_bit_identical(cuda, B, S, lengths):
    """Row 9 at G 16: a local layer's ring of 2048 rows (full and filling)
    and an 8k slot cache, bit for bit against the walk's replay."""
    rng = np.random.default_rng(S)
    shape = (B, S, KV, HD)
    ops = [torch.from_numpy(x).to(cuda) for x in (
        rng.normal(size=(B, KV, G, HD)).astype(np.float32), _codes(rng, shape),
        rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32), _codes(rng, shape),
        rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32),
        np.minimum(np.asarray(lengths, np.int64), S))]
    for q in (ops[0], ops[0].bfloat16()):
        want = KA.kv_cache_attention_plain(q, *ops[1:], bits=8)
        got = KA.kv_cache_attention_cuda(q, *ops[1:], bits=8)
        assert torch.equal(got, want)


def _wide_config(plan: str):
    """The reduced recurrentgemma (4 layers, d_rnn 64) with its local layer
    at the full model's head: 16 query heads over 1 KV head of hd 256, int8
    pool, bf16."""
    cfg = reduce_for_smoke(get_config("recurrentgemma-9b"))
    return dataclasses.replace(cfg, n_heads=G, n_kv_heads=KV, head_dim=HD,
                               kv_cache_dtype="int8", quant=qplan.get_plan(plan))


def _plain_gemms(cfg):
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend="ref"))


@pytest.mark.gpu
def test_reduced_recurrentgemma_engine_matches_plain_gemm_run(cuda):
    """The paged engine on the card (w2a2: every projection through
    ``lut_gemm``, the local layer's decode through ``paged_attention`` at
    G 16) against the same engine with the GEMMs on their plain versions:
    tokens and first-step logits bit for bit; exact launch counts. The
    33-token prompt's exact-length last chunk is one row, which attends
    through the one-token path: a ``paged_attention`` launch of its own."""
    cfg = _wide_config("w2a2")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                            pack=True)
    rng = np.random.default_rng(0)
    # 33 rows: a 32-row chunk, then an exact-length one of 1 row; 40 rows:
    # 32, then 8
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 19, 33, 40)]
    from repro_torch.kernels.lut_gemm import lut_gemm_cuda

    def run(c):
        eng = Engine(c, params, n_slots=2, max_len=64, block_size=16)
        first = {}
        inner = eng._decode_fn

        def decode(*a):
            logits = inner(*a)
            first.setdefault("logits", logits.clone())
            return logits

        eng._decode_fn = decode
        reqs = [Request(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
        for r in reqs:
            assert eng.submit(r)
        l0, a0 = lut_gemm_cuda.launches, PA.paged_attention_cuda.launches
        m = eng.run()
        forwards = m["decode_steps"] + m["prefill_chunks"]
        one_row = sum(len(p) % eng.chunk_size == 1 for p in prompts)
        assert one_row == 1
        return ([r.out for r in reqs], first["logits"], lut_gemm_cuda.launches - l0,
                PA.paged_attention_cuda.launches - a0, forwards,
                m["decode_steps"] + one_row)

    toks, logits, n_gemm, n_attn, forwards, one_token = run(cfg)
    assert n_gemm == (3 * 6 + 7) * forwards and n_attn == one_token
    ptoks, plogits, p_gemm, p_attn, _, p_one_token = run(_plain_gemms(cfg))
    assert p_gemm == 0 and p_attn == p_one_token
    assert toks == ptoks and torch.equal(logits, plogits)


@pytest.mark.gpu
def test_reduced_recurrentgemma_fixed_loop_matches_plain_gemm_run(cuda):
    """The fixed loop on the card past the local window (reduced to 16
    rows): a prompt of 40 tokens, its RG-LRU states carried into 5 decode
    steps whose local layer runs ``kv_cache_attention`` at G 16 on a
    wrapped ring; tokens and logits bit for bit against the plain-GEMM run."""
    cfg = _wide_config("w2a2")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(1), cuda,
                            pack=True)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 40))).to(cuda)

    def run(c):
        lg, caches = steps.make_prefill_step(c, max_len=46)(params, {"tokens": tokens})
        decode = steps.make_decode_step(c)
        out, logits = [lg[:, -1].argmax(-1)], [lg]
        for i in range(5):
            lg, caches = decode(params, caches, {"tokens": out[-1][:, None],
                                                 "pos": torch.full((2,), 40 + i,
                                                                   device=cuda)})
            out.append(lg[:, -1].argmax(-1))
            logits.append(lg)
        return torch.stack(out, 1), torch.stack(logits)

    before = KA.kv_cache_attention_cuda.launches
    toks, logits = run(cfg)
    assert KA.kv_cache_attention_cuda.launches - before == 5
    ptoks, plogits = run(_plain_gemms(cfg))
    assert torch.equal(toks, ptoks) and torch.equal(logits, plogits)
