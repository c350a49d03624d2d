"""The port's paged-attention CUDA kernels against their plain PyTorch
versions on the card (every test marked ``gpu``; each skips, from a
fixture, without a card). Run on the H100 with ``PYTHONPATH=src python -m
pytest -q -m gpu tests/test_torch_attention_gpu.py``. This file imports no
jax.

Tolerance: 1e-5 relative to max|plain| plus 1e-6 absolute. The kernels
sum f32 products and exponentials in another order than the plain
version's dense masked softmax, and factor the K scale out of the dot
product.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PA

RTOL = 1e-5
ATOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


def _operands(seed, *, bits, G, hd, lengths, nb, bs, KV=2, spare=3, dev,
              q_dtype=torch.float32):
    """A pool with shuffled physical blocks, NULL-padded int64 tables and
    lengths, on ``dev``."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    need = [-(-n // bs) for n in lengths]
    n_blocks = 1 + sum(need) + spare
    ids = rng.permutation(np.arange(1, n_blocks))
    tables = np.zeros((B, nb), np.int64)
    o = 0
    for b, k in enumerate(need):
        tables[b, :k] = ids[o:o + k]
        o += k
    width = hd * bits // 8
    if bits == 8:
        pools = [rng.integers(-127, 128, size=(n_blocks, bs, KV, width)).astype(np.int8)
                 for _ in range(2)]
    else:
        pools = [rng.integers(0, 256, size=(n_blocks, bs, KV, width)).astype(np.uint8)
                 for _ in range(2)]
    scs = [rng.uniform(0.005, 0.05, size=(n_blocks, bs, KV)).astype(np.float32)
           for _ in range(2)]
    q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32)).to(q_dtype)
    ops = [q, pools[0], scs[0], pools[1], scs[1], tables, np.asarray(lengths, np.int64)]
    return [x.to(dev) if torch.is_tensor(x) else torch.from_numpy(x).to(dev) for x in ops]


def _check(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=ATOL + RTOL * want.abs().max().item())


def _both(ops, bits, kv_splits):
    if kv_splits == 1:
        before = PA.paged_attention_cuda.launches
        got = PA.paged_attention_cuda(*ops, bits=bits)
        torch.cuda.synchronize()
        assert PA.paged_attention_cuda.launches == before + 1
        return got, PA.paged_attention_plain(*ops, bits=bits)
    before = PA.paged_attention_splitkv_cuda.launches
    got = PA.paged_attention_splitkv_cuda(*ops, bits=bits, kv_splits=kv_splits)
    torch.cuda.synchronize()
    assert PA.paged_attention_splitkv_cuda.launches == before + 1
    return got, PA.paged_attention_splitkv_plain(*ops, bits=bits, kv_splits=kv_splits)


_GRID = [(bits, G, hd, ks) for bits in (8, 4) for G in (1, 2, 8)
         for hd in (16, 64, 128) for ks in (1, 2, 3, 4, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("bits,G,hd,kv_splits", _GRID)
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(cuda, bits, G, hd, kv_splits, q_dtype):
    """bs 16, nb 6: lengths 1, 37 (not a multiple of bs) and 96 (the full
    table); kv_splits 4 and 5 leave chunks past every length."""
    ops = _operands(bits * 1000 + G * 100 + hd + kv_splits, bits=bits, G=G, hd=hd,
                    lengths=(1, 37, 96), nb=6, bs=16, dev=cuda, q_dtype=q_dtype)
    _check(*_both(ops, bits, kv_splits))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_splits", [1, 3, 8])
@pytest.mark.parametrize("bits,hd", [(8, 64), (4, 128), (8, 128)])
@pytest.mark.parametrize("G", [1, 4])
def test_kernels_match_plain_at_block_512_on_card(cuda, bits, hd, kv_splits, G):
    ops = _operands(kv_splits + hd, bits=bits, G=G, hd=hd, lengths=(700, 2048, 5),
                    nb=8, bs=512, KV=4, dev=cuda)
    _check(*_both(ops, bits, kv_splits))


# the single pass cut over a thread-block cluster of C > 1 ranks: (bs, nb,
# lengths, KV); each has a ragged length and a rank past a length
CLUSTER_TABLES = [
    (16, 64, (1000, 300, 1), 2),                    # C 2: ranks of 32 entries
    (16, 313, (4999, 700), 16),                     # the smoke's ragged row
    (512, 8, (4096, 700, 1), 2),                    # C 8: one entry a rank
    (512, 20, (8192, 8192), 16),                    # long 8k
    (512, 32, (16384, 5000, 1), 2),                 # C 16: non-portable
]


@pytest.mark.gpu
@pytest.mark.parametrize("bs,nb,lengths,KV", CLUSTER_TABLES)
@pytest.mark.parametrize("bits,G,hd", [(8, 1, 64), (4, 8, 128), (8, 4, 16)])
def test_single_pass_across_a_cluster_on_card(cuda, bs, nb, lengths, KV, bits, G, hd):
    C, _ = PA.cluster_ranks(nb * bs, len(lengths), KV, G, unit=bs)
    assert C > 1
    ops = _operands(nb + bs + G, bits=bits, G=G, hd=hd, lengths=lengths, nb=nb, bs=bs,
                    KV=KV, dev=cuda, q_dtype=torch.bfloat16)
    _check(*_both(ops, bits, 1))
    C_, clusters = PA.paged_attention_active_clusters(len(lengths), KV, G, hd, bs, nb,
                                                      bits, torch.bfloat16)
    assert C_ == C and clusters >= 1


# the split at and above one cluster of MAX_CLUSTER ranks: kv_splits 16 is
# one cluster of 16; 17, 24 and 32 are two clusters (9 + 8, 12 + 12, 16 +
# 16 ranks) and a merge pass. nb 40 of block 16: kv_splits 17 gives chunks
# of 3 entries, 24 and 32 chunks of 2, so the last ranks of the second
# cluster lie past nb; lengths 1, 300 (cutting a chunk) and 500 leave the
# chunks past row 500 past every length
SPLIT_CLUSTER_SHAPES = [(8, 1, 64), (4, 1, 128), (8, 4, 64), (4, 4, 128), (8, 8, 128),
                        (4, 8, 64)]


def _split_allocations(ops, bits, kv_splits):
    """The split kernel's output, its launches and the device allocations
    of one call (the output alone where no scratch is taken)."""
    stats = torch.cuda.memory_stats
    before = (PA.paged_attention_splitkv_cuda.launches, stats()["allocation.all.allocated"])
    got = PA.paged_attention_splitkv_cuda(*ops, bits=bits, kv_splits=kv_splits)
    torch.cuda.synchronize()
    return got, (PA.paged_attention_splitkv_cuda.launches - before[0],
                 stats()["allocation.all.allocated"] - before[1])


@pytest.mark.gpu
@pytest.mark.parametrize("kv_splits", [16, 17, 24, 32])
@pytest.mark.parametrize("bits,G,hd", SPLIT_CLUSTER_SHAPES)
def test_split_clusters_match_plain_on_card(cuda, bits, G, hd, kv_splits):
    ops = _operands(kv_splits * 10 + G + hd + bits, bits=bits, G=G, hd=hd,
                    lengths=(1, 300, 500), nb=40, bs=16, dev=cuda,
                    q_dtype=torch.bfloat16 if G == 4 else torch.float32)
    ns = PA.split_partition(40, kv_splits)[0]
    K, C = PA.split_clusters(ns, G, hd, bits)
    assert (K, C) == {16: (1, 16), 17: (2, 9), 24: (2, 12), 32: (2, 16)}[kv_splits]
    got, (launches, allocs) = _split_allocations(ops, bits, kv_splits)
    assert launches == 1
    assert allocs == (1 if K == 1 else 3)          # out, then acc and (m, l)
    _check(got, PA.paged_attention_splitkv_plain(*ops, bits=bits, kv_splits=kv_splits))
    K_, C_, active = PA.paged_attention_splitkv_active_clusters(
        3, 2, G, hd, 16, 40, bits, ops[0].dtype, kv_splits)
    assert (K_, C_) == (K, C) and active >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("kv_splits", [2, 16, 17, 33])
@pytest.mark.parametrize("bits,G,hd", [(8, 1, 64), (8, 8, 128), (4, 4, 128)])
def test_split_clusters_at_block_512_on_card(cuda, bits, G, hd, kv_splits):
    """Block 512, 40 entries: one entry a chunk from kv_splits 40 on;
    kv_splits 33 takes three clusters (11 ranks each), the last with
    chunks past nb."""
    ops = _operands(kv_splits + G + hd, bits=bits, G=G, hd=hd, lengths=(20000, 5, 700),
                    nb=40, bs=512, KV=2, dev=cuda)
    got, (launches, allocs) = _split_allocations(ops, bits, kv_splits)
    assert launches == 1 and allocs == (1 if kv_splits <= PA.MAX_CLUSTER else 3)
    _check(got, PA.paged_attention_splitkv_plain(*ops, bits=bits, kv_splits=kv_splits))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_splits", [3, 4, 7])
def test_split_kernel_above_table_width_on_card(cuda, kv_splits):
    ops = _operands(31, bits=8, G=2, hd=64, lengths=(3, 40), nb=3, bs=16, dev=cuda)
    got, _ = _both(ops, 8, kv_splits)
    _check(got, PA.paged_attention_plain(*ops, bits=8))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_splits", [1, 2])
def test_length_zero_returns_zero_on_card(cuda, kv_splits):
    ops = _operands(5, bits=4, G=2, hd=64, lengths=(0, 17), nb=2, bs=16, dev=cuda)
    got, want = _both(ops, 4, kv_splits)
    assert (got[0] == 0).all()
    _check(got[1:], want[1:])


@pytest.mark.gpu
def test_length_zero_through_two_clusters_on_card(cuda):
    """kv_splits 17 on 20 entries: two clusters and the merge pass, every
    rank of sequence 0 empty."""
    ops = _operands(6, bits=8, G=2, hd=64, lengths=(0, 170), nb=20, bs=16, dev=cuda)
    got, want = _both(ops, 8, 17)
    assert (got[0] == 0).all()
    _check(got[1:], want[1:])


@pytest.mark.gpu
def test_kernels_reject_bad_operands_on_card(cuda):
    ops = _operands(2, bits=8, G=2, hd=64, lengths=(5, 30), nb=2, bs=16, dev=cuda)
    q, kp, ksc, vp, vsc, tbl, lens = ops
    with pytest.raises(TypeError):
        PA.paged_attention_cuda(q.half(), *ops[1:], bits=8)
    with pytest.raises(TypeError):
        PA.paged_attention_cuda(*ops, bits=4)             # int8 codes as a 4-bit pool
    with pytest.raises(NotImplementedError):
        PA.paged_attention_cuda(*ops, bits=2)
    with pytest.raises(ValueError, match="contiguous"):
        PA.paged_attention_cuda(q.transpose(0, 1).contiguous().transpose(0, 1),
                                *ops[1:], bits=8)
    with pytest.raises(ValueError, match="int64"):
        PA.paged_attention_cuda(*ops[:5], tbl.int(), lens, bits=8)
    with pytest.raises(ValueError, match="scales"):
        PA.paged_attention_cuda(q, kp, ksc[:, :8].contiguous(), vp, vsc, tbl, lens,
                                bits=8)
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_attention_cuda(q, kp.cpu(), ksc, vp, vsc, tbl, lens, bits=8)
    with pytest.raises(NotImplementedError):
        wide = torch.zeros((2, 2, 9, 64), device=cuda)      # G = 9
        PA.paged_attention_cuda(wide, *ops[1:], bits=8)
    with pytest.raises(ValueError, match="kv_splits"):
        PA.paged_attention_splitkv_cuda(*ops, bits=8, kv_splits=0)
    with pytest.raises(NotImplementedError, match="block size"):
        PA.paged_attention_cuda(q, kp[:, :12].contiguous(), ksc[:, :12].contiguous(),
                                vp[:, :12].contiguous(), vsc[:, :12].contiguous(),
                                tbl, lens, bits=8)
