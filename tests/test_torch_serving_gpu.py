"""The port's paged engine on the card: a row of a batched prefill chunk
gets the bits it gets alone (``prefill_batch`` 2 gives the one-row run's
tokens), and seeded sampling draws the same tokens on the card as on the
CPU from the same logits (every test marked ``gpu``; each skips, from a
fixture, without a card). Run on the H100 with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serving_gpu.py``.
This file imports no jax.

Tolerance: none. The attention of a multi-row paged forward runs one
sequence at a time (CUDA's batched matmul picks its algorithm by the
batch count), and the sampler's noise is integer arithmetic.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import qplan
from repro_torch.models import lm
from repro_torch.serving import Engine, Request, SamplerConfig
from repro_torch.serving import sampler as S


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


def _serve(cfg, params, prompts, **kw):
    eng = Engine(cfg, params, n_slots=4, max_len=112, block_size=16, **kw)
    reqs = [Request(uid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    return [r.out for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize("sampled", [False, True])
def test_batched_prefill_rows_get_their_one_row_bits_on_card(cuda, sampled):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen1.5-0.5b")),
                              n_layers=2, kv_cache_dtype="int8",
                              quant=qplan.get_plan("w2a8_bs"))
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                            pack=True)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 48)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
               for n in (4, 9, 17, 30, 5, 12)]
    sc = SamplerConfig(temperature=0.8, top_k=50, top_p=0.9) if sampled else None
    one = _serve(cfg, params, prompts, sampler=sc)
    assert _serve(cfg, params, prompts, sampler=sc, prefill_batch=2) == one
    assert _serve(cfg, params, prompts, sampler=sc, prefix_cache=True) == one


@pytest.mark.gpu
def test_seeded_draws_are_the_same_on_card_and_cpu(cuda):
    B, V = 6, 151936
    logits = torch.from_numpy(
        4 * np.random.default_rng(1).standard_normal((B, V)).astype(np.float32))
    rows = dict(uids=torch.arange(B) * 11, sidx=torch.arange(B),
                temperature=torch.tensor([0.8, 0.0, 1.2, 0.5, 0.8, 2.0]),
                top_p=torch.tensor([0.9, 1.0, 0.95, 1.0, 0.5, 1.0]))
    cfg = SamplerConfig(top_k=50, seed=3)
    want = S.sample(logits, cfg, **rows)
    got = S.sample(logits.to(cuda), cfg, rows["uids"].to(cuda), rows["sidx"].to(cuda),
                   rows["temperature"], rows["top_p"])
    assert torch.equal(got.cpu(), want)
    for tag in (S.TAG_DECODE, S.TAG_ACCEPT):
        a = S.uniform(3, rows["uids"], rows["sidx"], tag, 1000)
        b = S.uniform(3, rows["uids"].to(cuda), rows["sidx"].to(cuda), tag, 1000)
        assert torch.equal(a, b.cpu())
