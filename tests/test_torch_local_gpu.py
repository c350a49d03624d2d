"""The decode-attention kernels of the local-attention slice on the card: a
local layer's window through the paged pair (``paged_attention``,
``paged_attention_splitkv``) and head dims 256 and 120 through all three
(``kv_cache_attention`` included), against their plain PyTorch versions.
Every test is marked ``gpu`` and skips, from a fixture, without a card.
Run on the H100 with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_local_gpu.py``. This file imports no jax.

Tolerances: the paged pair within 1e-5 of max|plain| plus 1e-6 absolute
(f32 sums and exponentials in another order than the plain version's
dense masked softmax, the K scale factored out of the dot product);
``kv_cache_attention`` bit for bit against its plain version, the replay
of its walk.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import kv_cache_attention as KA
from repro_torch.kernels import paged_attention as PA

RTOL = 1e-5
ATOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


def _codes(rng, shape, bits):
    if bits == 8:
        return rng.integers(-127, 128, size=shape).astype(np.int8)
    return rng.integers(0, 256, size=shape).astype(np.uint8)


def _paged(seed, *, bits, G, hd, lengths, bs, KV=2, spare=3, dev):
    """q, a pool whose blocks each sequence owns in a shuffled order, the
    NULL-padded int64 tables (two spare entries) and the lengths."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    need = [-(-n // bs) for n in lengths]
    nb = max(need) + 2
    n_blocks = 1 + sum(need) + spare
    ids = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, nb), np.int64)
    o = 0
    for b, k in enumerate(need):
        tables[b, :k] = ids[o:o + k]
        o += k
    shape = (n_blocks, bs, KV, hd * bits // 8)
    ops = [rng.normal(size=(B, KV, G, hd)).astype(np.float32),
           _codes(rng, shape, bits),
           rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32),
           _codes(rng, shape, bits),
           rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32),
           tables, np.asarray(lengths, np.int64)]
    return [torch.from_numpy(x).to(dev) for x in ops]


def _close(got, want):
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0,
                               atol=ATOL + RTOL * want.abs().max().item())


# (hd, bits, G, bs, lengths, window): the window's lower bound on a block
# boundary and off it, a window shorter than a block and than a tile,
# lengths at or below the window (nothing cut), ranks and chunks wholly
# below the window, and gemma3's (G 2, hd 256) and danube's (G 4, hd 120)
# heads
_WINDOWED = [
    (256, 8, 2, 16, (1100, 300), 1024),      # lo 76 (off a block), lo 0
    (256, 8, 2, 16, (1040, 1024), 1024),     # lo 16 (a block boundary), lo 0
    (120, 8, 4, 16, (4100, 4096), 4096),     # lo 4, lo 0
    (120, 8, 4, 512, (5000, 9000), 4096),    # 512-row blocks, lo 904 and 4904
    (64, 8, 2, 16, (300, 37), 10),           # a window shorter than a block
    (64, 4, 1, 256, (700, 129), 100),        # shorter than a tile
    (128, 4, 8, 16, (2000, 1), 700),         # length 1
    (256, 4, 2, 16, (900, 900), 1000),       # every length below the window
    (16, 8, 2, 16, (3000, 2999), 128),       # a window of exactly one tile
]


@pytest.mark.gpu
@pytest.mark.parametrize("hd,bits,G,bs,lengths,window", _WINDOWED)
@pytest.mark.parametrize("kv_splits", [1, 3, 8, 20])
def test_windowed_paged_kernels_match_plain(cuda, hd, bits, G, bs, lengths, window,
                                            kv_splits):
    ops = _paged(hd + bs + len(lengths), bits=bits, G=G, hd=hd, lengths=lengths,
                 bs=bs, dev=cuda)
    if kv_splits == 1:
        before = PA.paged_attention_cuda.launches
        got = PA.paged_attention_cuda(*ops, bits=bits, window=window)
        want = PA.paged_attention_plain(*ops, bits=bits, window=window)
        assert PA.paged_attention_cuda.launches == before + 1
    else:
        before = PA.paged_attention_splitkv_cuda.launches
        got = PA.paged_attention_splitkv_cuda(*ops, bits=bits, kv_splits=kv_splits,
                                              window=window)
        want = PA.paged_attention_splitkv_plain(*ops, bits=bits, kv_splits=kv_splits,
                                                window=window)
        assert PA.paged_attention_splitkv_cuda.launches == before + 1
    torch.cuda.synchronize()
    _close(got, want)
    # the window moves the answer wherever it cuts a length
    if any(n > window for n in lengths):
        whole = PA.paged_attention_plain(*ops, bits=bits)
        cut = [b for b, n in enumerate(lengths) if n > window]
        assert not torch.allclose(got[cut], whole[cut])


@pytest.mark.gpu
@pytest.mark.parametrize("hd,bits", [(256, 8), (256, 4), (120, 8)])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("kv_splits", [1, 2, 24])
def test_new_head_dims_paged_match_plain(cuda, hd, bits, G, kv_splits):
    ops = _paged(7 * G + kv_splits, bits=bits, G=G, hd=hd, lengths=(33, 2100, 700),
                 bs=16, dev=cuda)
    if kv_splits == 1:
        got = PA.paged_attention_cuda(*ops, bits=bits)
        want = PA.paged_attention_plain(*ops, bits=bits)
    else:
        got = PA.paged_attention_splitkv_cuda(*ops, bits=bits, kv_splits=kv_splits)
        want = PA.paged_attention_splitkv_plain(*ops, bits=bits, kv_splits=kv_splits)
    torch.cuda.synchronize()
    _close(got, want)


def _dense(seed, *, B, S, KV, G, hd, bits, lengths, dev, q_dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    shape = (B, S, KV, hd * bits // 8)
    ops = [torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32)).to(q_dtype),
           _codes(rng, shape, bits),
           rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32),
           _codes(rng, shape, bits),
           rng.uniform(0.005, 0.05, size=shape[:3]).astype(np.float32),
           np.asarray(lengths, np.int64)]
    return [(x if torch.is_tensor(x) else torch.from_numpy(x)).to(dev) for x in ops]


# (hd, bits, G, B, S, lengths): a ring of W rows, full (min(pos + 1, W) =
# W) and filling, and a long cache that several ranks walk
_DENSE = [
    (256, 8, 2, 4, 1024, (1024, 1024, 17, 1000)),
    (120, 8, 4, 2, 4096, (4096, 3000)),
    (256, 4, 1, 2, 48, (33, 47)),
    (120, 8, 1, 3, 8208, (8208, 5000, 1)),
    (256, 8, 8, 1, 2000, (1999,)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("hd,bits,G,B,S,lengths", _DENSE)
def test_new_head_dims_kv_cache_bit_identical(cuda, hd, bits, G, B, S, lengths):
    ops = _dense(hd + S, B=B, S=S, KV=2, G=G, hd=hd, bits=bits, lengths=lengths,
                 dev=cuda)
    before = KA.kv_cache_attention_cuda.launches
    got = KA.kv_cache_attention_cuda(*ops, bits=bits)
    torch.cuda.synchronize()
    assert KA.kv_cache_attention_cuda.launches == before + 1
    want = KA.kv_cache_attention_plain(*ops, bits=bits)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.gpu
def test_int4_at_hd_120_raises_on_every_kernel(cuda):
    """An int4 row of 120 dims is 60 bytes: every kernel refuses it loudly,
    none falls back."""
    ops = _paged(0, bits=4, G=4, hd=120, lengths=(40,), bs=16, dev=cuda)
    dense = _dense(0, B=1, S=48, KV=2, G=4, hd=120, bits=4, lengths=(40,), dev=cuda)
    counts = (PA.paged_attention_cuda.launches, PA.paged_attention_splitkv_cuda.launches,
              KA.kv_cache_attention_cuda.launches)
    with pytest.raises(NotImplementedError, match="8-byte"):
        PA.paged_attention_cuda(*ops, bits=4, window=16)
    with pytest.raises(NotImplementedError, match="8-byte"):
        PA.paged_attention_splitkv_cuda(*ops, bits=4, kv_splits=2)
    with pytest.raises(NotImplementedError, match="8-byte"):
        KA.kv_cache_attention_cuda(*dense, bits=4)
    assert counts == (PA.paged_attention_cuda.launches,
                      PA.paged_attention_splitkv_cuda.launches,
                      KA.kv_cache_attention_cuda.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,G", [(256, 2), (120, 4), (256, 8)])
def test_wide_heads_fit_their_clusters(cuda, hd, G):
    """At the ranks ``cluster_ranks`` and ``split_clusters`` choose, the card
    holds at least one cluster of every launch at these head dims; at hd
    256 (one block an SM) it holds every cluster of a single pass at once
    (``WIDE_RESIDENT``)."""
    for B, nb in ((1, 68), (2, 68), (4, 68), (4, 4)):
        for window in (None, 1024):
            C, active = PA.paged_attention_active_clusters(B, 8, G, hd, 512, nb, 8,
                                                           torch.bfloat16, window=window)
            assert active >= 1, (B, nb, C, active)
            if hd > PA.WIDE_HD:
                assert active >= B * 8, (B, nb, window, C, active)
        for ks in (8, 24):
            K, C, active = PA.paged_attention_splitkv_active_clusters(
                B, 8, G, hd, 512, nb, 8, torch.bfloat16, ks)
            assert active >= 1, (B, nb, ks, K, C, active)
        C, active = KA.kv_cache_attention_active_clusters(B, 1024, 8, G, hd, 8,
                                                          torch.bfloat16)
        assert active >= (B * 8 if hd > PA.WIDE_HD else 1), (B, C, active)
