"""The port's dense-cache attention kernel (``csrc/kv_cache_attention.cu``)
against its plain PyTorch version on the card, and one fixed-batch serve
of the reduced qwen1.5-0.5b through it (every test marked ``gpu``; each
skips, from a fixture, without a card). Run on the H100 with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fixed_gpu.py``.
This file imports no jax.

Tolerance: none. The plain version replays the kernel's walk operation
for operation (the same cluster ranks, each product and sum rounded on its
own, in the kernel's order, and the ranks merged in the kernel's order),
so the two must agree bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import qplan
from repro_torch.kernels import kv_cache_attention as KA
from repro_torch.launch import serve, steps
from repro_torch.models import lm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the gpu-marked tests on the H100)")
    return torch.device("cuda")


def _operands(seed, *, bits, KV, G, hd, S, lengths, dev, q_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    width = hd * bits // 8
    if bits == 8:
        codes = [rng.integers(-127, 128, size=(B, S, KV, width)).astype(np.int8)
                 for _ in range(2)]
    else:
        codes = [rng.integers(0, 256, size=(B, S, KV, width)).astype(np.uint8)
                 for _ in range(2)]
    scs = [rng.uniform(0.005, 0.05, size=(B, S, KV)).astype(np.float32)
           for _ in range(2)]
    q = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32)).to(q_dtype)
    ops = [q, codes[0], scs[0], codes[1], scs[1], np.asarray(lengths, np.int64)]
    return [x.to(dev) if torch.is_tensor(x) else torch.from_numpy(x).to(dev) for x in ops]


def _both(ops, bits):
    before = KA.kv_cache_attention_cuda.launches
    got = KA.kv_cache_attention_cuda(*ops, bits=bits)
    torch.cuda.synchronize()
    assert KA.kv_cache_attention_cuda.launches == before + 1
    return got, KA.kv_cache_attention_plain(*ops, bits=bits)


def _check(got, want):
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), (got - want).abs().max().item()


_GRID = [(bits, G, hd) for bits in (8, 4) for G in (1, 3, 8) for hd in (16, 32, 64, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("bits,G,hd", _GRID)
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda, bits, G, hd, q_dtype):
    """S 300 (off every tile): lengths 1, 128 (one whole tile), 129 and
    300."""
    ops = _operands(bits * 1000 + G * 100 + hd, bits=bits, KV=2, G=G, hd=hd, S=300,
                    lengths=(1, 128, 129, 300), dev=cuda, q_dtype=q_dtype)
    _check(*_both(ops, bits))


# the serve shapes of chip_smoke.py phase 4: (B, KV, G, hd, bits, S, lengths)
SERVE_SHAPES = [
    (4, 16, 1, 64, 8, 48, (33, 38, 42, 47)),        # qwen1.5-0.5b, P 32 + gen 16
    (4, 32, 1, 128, 4, 48, (33, 38, 42, 47)),       # codeqwen1.5-7b, int4
    (2, 4, 4, 64, 8, 1000, (999, 517)),             # GQA, S off a power of two
    (2, 16, 1, 64, 8, 8192, (8192, 8192)),          # long context
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,KV,G,hd,bits,S,lengths", SERVE_SHAPES)
def test_kernel_matches_plain_at_serve_shapes_on_card(cuda, B, KV, G, hd, bits, S,
                                                      lengths):
    ops = _operands(S + hd, bits=bits, KV=KV, G=G, hd=hd, S=S, lengths=lengths,
                    dev=cuda, q_dtype=torch.bfloat16)
    _check(*_both(ops, bits))


# the rows cut over a thread-block cluster of C > 1 ranks: (B, KV, G, hd,
# bits, S, lengths, C); each has a ragged length and a rank past a length
CLUSTER_SHAPES = [
    (2, 2, 3, 64, 8, 600, (599, 300), 2),           # ragged last rank (216 rows)
    (2, 2, 3, 64, 8, 1000, (999, 300), 4),          # ranks 2-3 past 300
    (3, 2, 1, 16, 4, 1792, (1792, 1, 1000), 7),     # ranks of 256 rows
    (2, 16, 1, 64, 8, 5000, (4999, 700), 10),       # ranks 2-9 past 700
    (2, 4, 8, 128, 4, 4096, (4096, 129), 16),       # G 8, hd 128, int4
    (2, 16, 1, 64, 8, 8192, (8192, 1), 11),         # long 8k; ranks 1-10 past 1
    (1, 4, 1, 64, 8, 8192, (8191,), 16),            # a non-portable cluster of 16
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,KV,G,hd,bits,S,lengths,C", CLUSTER_SHAPES)
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_across_a_cluster_on_card(cuda, B, KV, G, hd, bits, S,
                                                        lengths, C, q_dtype):
    assert KA.cluster_ranks(S, B, KV, G)[0] == C
    ops = _operands(S + hd + C, bits=bits, KV=KV, G=G, hd=hd, S=S, lengths=lengths,
                    dev=cuda, q_dtype=q_dtype)
    _check(*_both(ops, bits))
    C_, clusters = KA.kv_cache_attention_active_clusters(B, S, KV, G, hd, bits, q_dtype)
    assert C_ == C and clusters >= 1


@pytest.mark.gpu
def test_length_zero_returns_zero_and_long_lengths_read_S_rows_on_card(cuda):
    ops = _operands(5, bits=4, KV=2, G=2, hd=64, S=40, lengths=(0, 17, 90), dev=cuda)
    got, want = _both(ops, 4)
    assert (got[0] == 0).all()
    _check(got[1:], want[1:])
    ops = _operands(6, bits=8, KV=2, G=1, hd=64, S=4096, lengths=(0, 5000), dev=cuda)
    got, want = _both(ops, 8)                # C 8: every rank of sequence 0 is empty
    assert (got[0] == 0).all()
    _check(got[1:], want[1:])


@pytest.mark.gpu
def test_kernel_rejects_bad_operands_on_card(cuda):
    ops = _operands(2, bits=8, KV=2, G=2, hd=64, S=30, lengths=(5, 30), dev=cuda)
    q, k, ksc, v, vsc, lens = ops
    with pytest.raises(TypeError):
        KA.kv_cache_attention_cuda(q.half(), *ops[1:], bits=8)
    with pytest.raises(TypeError):
        KA.kv_cache_attention_cuda(*ops, bits=4)           # int8 codes as 4-bit
    with pytest.raises(NotImplementedError):
        KA.kv_cache_attention_cuda(*ops, bits=2)
    with pytest.raises(ValueError, match="contiguous"):
        KA.kv_cache_attention_cuda(q.transpose(0, 1).contiguous().transpose(0, 1),
                                   *ops[1:], bits=8)
    with pytest.raises(ValueError, match="int64"):
        KA.kv_cache_attention_cuda(*ops[:5], lens.int(), bits=8)
    with pytest.raises(ValueError, match="scales"):
        KA.kv_cache_attention_cuda(q, k, ksc[:, :8].contiguous(), v, vsc, lens, bits=8)
    with pytest.raises(ValueError, match="pools must be"):
        KA.kv_cache_attention_cuda(q, k[:1].contiguous(), ksc[:1].contiguous(), v, vsc,
                                   lens, bits=8)
    with pytest.raises(ValueError, match="CUDA"):
        KA.kv_cache_attention_cuda(q, k.cpu(), ksc, v, vsc, lens, bits=8)
    with pytest.raises(NotImplementedError):
        KA.kv_cache_attention_cuda(torch.zeros((2, 2, 9, 64), device=cuda), *ops[1:],
                                   bits=8)                  # G = 9
    with pytest.raises(NotImplementedError):
        KA.kv_cache_attention_cuda(torch.zeros((2, 2, 2, 48), device=cuda), *ops[1:],
                                   bits=8)                  # hd = 48


@pytest.mark.gpu
def test_kernel_launch_failure_raises_on_card(cuda):
    """65536 sequences exceed the grid's y limit: the launch is refused, and
    the wrapper raises instead of returning an unwritten output."""
    ops = _operands(3, bits=8, KV=1, G=1, hd=16, S=1, lengths=(1,) * 65536, dev=cuda)
    before = KA.kv_cache_attention_cuda.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        KA.kv_cache_attention_cuda(*ops, bits=8)
    assert KA.kv_cache_attention_cuda.launches == before
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_fixed_batch_serve_on_card(cuda, kv):
    """The reduced qwen1.5-0.5b (float32, int8/int4 cache) through the
    fixed-batch loop on the card: every decode step of every layer
    launches the kernel once, and the run with attention on its plain
    version gives the same greedy tokens and first-step logits."""
    args = serve.build_parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cuda", "--plan", "w2a16",
         "--gen", "6"])
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen1.5-0.5b")),
                              dtype="float32", kv_cache_dtype=kv,
                              quant=qplan.get_plan("w2a16"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    qparams = lm.init_params(cfg, gen, cuda, pack=True)
    before = KA.kv_cache_attention_cuda.launches
    res = serve.serve_fixed(cfg, qparams, args)
    assert KA.kv_cache_attention_cuda.launches - before == cfg.n_layers * (args.gen - 1)
    assert torch.isfinite(res["first_logits"]).all()
    ref = serve.serve_fixed(cfg, qparams, args,
                            decode_step=steps.make_decode_step(cfg, attn_backend="ref"))
    assert (res["tokens"] == ref["tokens"]).all()
    assert torch.equal(res["first_logits"], ref["first_logits"])
