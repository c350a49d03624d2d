"""Per-request sampler stack of the port's engine.

The port's counterpart of ``repro/serving/sampler.py``:

  temperature -> top-k -> top-p -> seeded Gumbel-max draw

per batch row, with per-request temperature and top-p ((B,) rows) and one
engine-wide ``top_k``. ``probs`` is also the distribution speculative
decoding's rejection sampler consumes (serving/spec.py).

Greedy rows (temperature <= 0) are a one-hot at the argmax of the raw
logits, so their draw is that argmax for any noise; ties go to the first
index, as in the reference. ``sample`` of an all-greedy batch is the argmax
itself, without the warp.

Noise. The reference derives every draw from threefry keys
``fold_in(fold_in(PRNGKey(seed), uid), sidx)`` folded by a purpose tag;
the port cannot reproduce threefry's bits. Its draws come from a
counter-based integer hash of ``(seed, uid, sidx, tag[, step], index)``
(``_key`` and ``_bits``), written in plain torch int64 ops whose every
intermediate stays below 2^63, so the CPU and the card draw the same bits.
The 32-bit hash is mapped to a uniform in the open interval (0, 1) exactly,
then to Gumbel noise ``-log(-log u)``. The reference's determinism
contract holds unchanged: slot index, batch composition and
``prefill_batch`` never enter a draw, so a seeded run is reproducible
across runs and re-batchings, and requests draw independently.

The draw is split in two: the noise (``gumbel``), and
``draw_from_noise(p, gumbel) = argmax(log p + gumbel)``, which is what
``jax.random.categorical`` computes from ``jax.random.gumbel`` noise of the
same key, so the tests can feed the reference's own noise.
"""

from __future__ import annotations

import dataclasses

import torch

# purpose tags: the plain decode draw, the drafter's draws, the accept
# thresholds and the residual resample are four independent streams
TAG_DECODE = 0
TAG_DRAFT = 1
TAG_ACCEPT = 2
TAG_RESAMPLE = 3

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Engine-wide sampler defaults (``Request.temperature`` and
    ``Request.top_p`` override the first and third per request).

    temperature  0.0 => greedy argmax (the default)
    top_k        keep the k highest-probability tokens (0 = off)
    top_p        keep the minimal prefix of the sorted distribution whose
                 cumulative probability covers p (1.0 = off)
    seed         base seed of every draw
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


# ---------------------------------------------------------------- noise --

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32): the constant in two 16-bit
    halves keeps every product below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (lowbias32) over int64 values in [0,
    2^32): a bijection with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _key(seed: int, uids: torch.Tensor, sidx: torch.Tensor, tag: int,
         step=None) -> torch.Tensor:
    """(B,) 32-bit keys from (seed, uid, sample index, tag[, step]):
    nothing of the slot or the batch enters. uids and sidx are int64 in
    [0, 2^32); ``step`` is an int or a (B,) tensor."""
    h = torch.full_like(uids, 0)
    for part in (seed & _M32, (seed >> 32) & _M32):
        h = _mix(h ^ part)
    h = _mix(h ^ (uids & _M32))
    h = _mix(h ^ (sidx & _M32))
    h = _mix(h ^ tag)
    if step is not None:
        h = _mix(h ^ step)
    return h


def _bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) 32-bit words: element i of row b hashes (key_b, i)."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k2 = _mix(key ^ 0x5BD1E995)
    return _mix(_mix(key[:, None] ^ idx[None]) ^ k2[:, None])


def uniform(seed: int, uids, sidx, tag: int, n: int, step=None) -> torch.Tensor:
    """(B, n) f32 uniforms in the open interval (0, 1): the top 23 bits of
    each word as (2 m + 1) 2^-24, exact in f32."""
    w = _bits(_key(seed, uids, sidx, tag, step), n)
    return ((w >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24


def gumbel(seed: int, uids, sidx, tag: int, n: int, step=None) -> torch.Tensor:
    """(B, n) f32 standard Gumbel noise -log(-log u), computed in f64."""
    u = uniform(seed, uids, sidx, tag, n, step).double()
    return (-torch.log(-torch.log(u))).float()


# ----------------------------------------------------------------- warp --

def warp_logits(logits: torch.Tensor, temperature: torch.Tensor, top_k: int,
                top_p: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 logits with per-row temperature (B,) and top_p (B,) ->
    filtered logits, excluded entries at -inf. Top-p keeps sorted element
    i iff the mass before it is < p: the first element always, and the
    boundary element that crosses p (the minimal covering prefix). Greedy
    rows are ``probs``' business."""
    V = logits.shape[-1]
    t = torch.where(temperature > 0, temperature,
                    torch.ones_like(temperature))[:, None]
    x = logits / t
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    if top_k and top_k < V:
        kth = torch.topk(x, top_k, dim=-1).values[:, -1:]
        x = torch.where(x < kth, neg, x)
    order = torch.argsort(-x, dim=-1, stable=True)
    sx = torch.gather(x, -1, order)
    sp = torch.softmax(sx, dim=-1)
    before = torch.cumsum(sp, dim=-1) - sp
    sx = torch.where(before < top_p[:, None], sx, neg)
    return torch.empty_like(sx).scatter_(-1, order, sx)


def probs(logits: torch.Tensor, temperature, top_k: int, top_p) -> torch.Tensor:
    """(B, V) f32 logits and (B,) rows of temperature and top_p (host or
    device) -> the distribution each row samples from: softmax of the
    warped logits, or for greedy rows a one-hot at the argmax of the raw
    logits (an all-greedy batch skips the warp)."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    onehot = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]).to(logits.dtype)
    sampled = temperature > 0
    if not bool(sampled.any()):
        return onehot
    dev = logits.device
    warped = torch.softmax(warp_logits(
        logits, temperature.to(dev), top_k,
        torch.as_tensor(top_p, dtype=torch.float32).to(dev)), dim=-1)
    return torch.where(sampled.to(dev)[:, None], warped, onehot)


def draw_from_noise(p: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """argmax(log p + noise) per row: with Gumbel noise a draw from p; a
    one-hot row returns its index for any noise (log 0 = -inf)."""
    return torch.argmax(torch.log(p) + noise, dim=-1)


def sample(logits: torch.Tensor, cfg: SamplerConfig, uids: torch.Tensor,
           sidx: torch.Tensor, temperature, top_p) -> torch.Tensor:
    """The engine's plain decode draw. (B, V) f32 logits, (B,) int64 uids
    and sample indices on the logits' device, (B,) host rows of temperature
    and top_p -> (B,) int64 token ids. An all-greedy batch is the argmax of
    the raw logits, with no noise drawn."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    if not bool((temperature > 0).any()):
        return torch.argmax(logits, dim=-1)
    p = probs(logits, temperature, cfg.top_k, top_p)
    return draw_from_noise(p, gumbel(cfg.seed, uids, sidx, TAG_DECODE,
                                     logits.shape[-1]))
