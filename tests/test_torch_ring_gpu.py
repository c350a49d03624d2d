"""Rows 5 and 6 (``paged_attention``, ``paged_attention_splitkv``) on a
ring-paged local layer's pool, on the card: a slot's ring of ring_len =
ceil((window + 31) / 16) blocks (chunks of 32 rows, blocks of 16), spelled
out as an absolute table of the full table's width (entry j: ring block j
% ring_len, ``serving/cache.py::ring_abs_row``), holding the rows [length
- window, length) of a full table, and garbage elsewhere. The kernels read
only those rows, so their output is the full table's bit for bit, with
one launch a call. Heads hd 64, 128, 256 and 120 (run as 128), windows
1024 and 4096, lengths 48 to 32768 (past several wraps of the ring), and
kv_splits 1, 8 and 24. Every test is marked ``gpu`` and skips, from a
fixture, without a card. Run on the H100 with ``PYTHONPATH=src python -m
pytest -q -m gpu tests/test_torch_ring_gpu.py``. This file imports no
jax.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.serving.cache import ring_abs_row

BS = 16
CHUNK = 32
LENGTHS = (48, 1100, 9000, 32768)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


def _operands(seed, *, hd, G, bits, window, dev, KV=2):
    """(full, ring) operand tuples for the paged pair: the same q and
    lengths; a full pool with shuffled int64 tables, and a ring pool whose
    absolute tables (as wide as the full ones) hold the live rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(LENGTHS)
    nb = max(-(-n // BS) for n in LENGTHS) + 1
    ring_len = -(-(window + CHUNK - 1) // BS)
    width = hd * bits // 8

    def pool(n):
        lo, hi = (-127, 128) if bits == 8 else (0, 256)
        codes = torch.randint(lo, hi, (n, BS, KV, width), generator=gen, device=dev,
                              dtype=torch.int16).to(PA.POOL_DTYPE[bits])
        sc = torch.rand((n, BS, KV), generator=gen, device=dev) * 0.045 + 0.005
        return codes, sc

    n_full, n_ring = 1 + B * nb, 1 + B * ring_len
    (k, ks), (v, vs) = pool(n_full), pool(n_full)
    (rk, rks), (rv, rvs) = pool(n_ring), pool(n_ring)
    rng = np.random.default_rng(seed)
    tables = torch.from_numpy(rng.permutation(np.arange(1, n_full)).reshape(B, nb)
                              .astype(np.int64)).to(dev)
    rings = rng.permutation(np.arange(1, n_ring)).reshape(B, ring_len)
    absolute = torch.from_numpy(np.stack([ring_abs_row(list(r), nb) for r in rings])
                                ).to(dev)
    for b, n in enumerate(LENGTHS):
        t = torch.arange(max(0, n - window), n, device=dev)
        src = tables[b, t // BS], t % BS
        dst = absolute[b, t // BS], t % BS
        for f, r in ((k, rk), (ks, rks), (v, rv), (vs, rvs)):
            r[dst] = f[src]
    q = torch.randn((B, KV, G, hd), generator=gen, device=dev).to(torch.bfloat16)
    lens = torch.tensor(LENGTHS, dtype=torch.int64, device=dev)
    return (q, k, ks, v, vs, tables, lens), (q, rk, rks, rv, rvs, absolute, lens)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,G,bits", [(64, 4, 4), (128, 4, 8), (256, 2, 8), (120, 4, 8)])
@pytest.mark.parametrize("window", [1024, 4096])
@pytest.mark.parametrize("kv_splits", [1, 8, 24])
def test_paged_pair_on_a_ring_is_bitwise_the_full_table(cuda, hd, G, bits, window,
                                                        kv_splits):
    full, ring = _operands(hd + window + kv_splits, hd=hd, G=G, bits=bits,
                           window=window, dev=cuda)
    assert LENGTHS[-1] > 4 * (-(-(window + CHUNK - 1) // BS)) * BS    # wraps
    if kv_splits == 1:
        wrapper, kw = PA.paged_attention_cuda, {}
    else:
        wrapper, kw = PA.paged_attention_splitkv_cuda, {"kv_splits": kv_splits}
    outs = []
    for ops in (ring, full):
        before = wrapper.launches
        outs.append(wrapper(*ops, bits=bits, window=window, **kw))
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
    got, want = outs
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), (got - want).abs().max().item()
