"""The port's sampler stack and rejection sampler against the JAX
reference's (``repro.serving.sampler`` / ``repro.serving.spec``).

The deterministic parts must agree on the same inputs: ``warp_logits`` and
``probs`` to 1e-6 absolute on the probabilities, with the same support;
``draw_from_noise`` fed ``jax.random.gumbel`` of the reference's own keys
gives ``sampler.draw``'s tokens exactly (``jax.random.categorical`` is
``argmax(gumbel(key, (V,)) + logits)``); and the port's
``reject_sample_from_noise`` fed the reference's own uniforms and residual
noise gives ``spec.reject_sample``'s accept counts and tokens exactly.

The port's own noise (a counter-based integer hash, not threefry) is held
to its contract: the same bits as a plain Python model of the hash (so no
int64 product overflows), uniforms in the open interval (0, 1), the same
draw for the same (seed, uid, sidx, tag) in any batch, independent
streams for different uids, and a 10k-draw rejection-sampling marginal
that matches the target distribution by a stated chi-square bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampler as JS
from repro.serving import spec as JSP
from repro_torch.serving import sampler as S
from repro_torch.serving import spec as SP
from repro_torch.serving.sampler import SamplerConfig

ATOL_PROBS = 1e-6
# chi-square bounds on 10k draws (31 degrees of freedom: mean 31, sd 7.9;
# P(chi2 > 70) ~ 1e-4), one fixed grid of draws, so no flake
CHI2_BOUND = 70.0

TEMPS = np.asarray([0.7, 0.0, 1.3, 0.4, 0.0, 2.0], np.float32)
TOPPS = np.asarray([0.9, 1.0, 0.5, 0.99, 0.3, 1.0], np.float32)


def _logits(seed: int, B: int, V: int, scale: float = 4.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal((B, V))).astype(np.float32)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype else t


# --------------------------------------------------------------------------- #
# The warp stack against the reference
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_warp_and_probs_match_reference(seed, top_k):
    lg = _logits(seed, len(TEMPS), 33)
    want_w = np.asarray(JS.warp_logits(jnp.asarray(lg), jnp.asarray(TEMPS), top_k,
                                       jnp.asarray(TOPPS)))
    got_w = S.warp_logits(_t(lg), _t(TEMPS), top_k, _t(TOPPS)).numpy()
    # greedy rows' warp is discarded by probs (and at top_p 1.0 their f32
    # cumulative mass decides the tail's membership by rounding)
    want_w, got_w = want_w[TEMPS > 0], got_w[TEMPS > 0]
    np.testing.assert_array_equal(np.isfinite(got_w), np.isfinite(want_w))
    fin = np.isfinite(want_w)
    np.testing.assert_allclose(got_w[fin], want_w[fin], rtol=1e-6)
    want = np.asarray(JS.probs(jnp.asarray(lg), jnp.asarray(TEMPS), top_k,
                               jnp.asarray(TOPPS)))
    got = S.probs(_t(lg), _t(TEMPS), top_k, _t(TOPPS)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PROBS)
    # greedy rows are a one-hot at the raw argmax
    for b in np.flatnonzero(TEMPS <= 0):
        assert got[b].argmax() == lg[b].argmax() and got[b].max() == 1.0


def test_all_greedy_batch_is_argmax_with_ties_to_the_first_index():
    lg = _logits(5, 4, 40)
    lg[1, [3, 17]] = lg[1].max() + 1.0            # a tie: index 3 wins
    rows = dict(uids=torch.arange(4), sidx=torch.zeros(4, dtype=torch.int64),
                temperature=torch.zeros(4), top_p=torch.ones(4))
    got = S.sample(_t(lg), SamplerConfig(), **rows)
    np.testing.assert_array_equal(got.numpy(), np.argmax(lg, -1))
    assert int(got[1]) == 3
    # the one-hot route gives the same tokens for any noise
    p = S.probs(_t(lg), rows["temperature"], 0, rows["top_p"])
    noise = S.gumbel(0, rows["uids"], rows["sidx"], S.TAG_DECODE, 40)
    np.testing.assert_array_equal(S.draw_from_noise(p, noise).numpy(), got.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_near_zero_temperature_concentrates_on_argmax_given_a_margin(seed):
    """The reference's near-zero-temperature property holds where the top-2
    logit margin is resolvable at that temperature (margin / T >= 20);
    without such a margin it can fail in either framework."""
    B, V, T = 64, 33, 1e-3
    lg = _logits(seed, B, V)
    top2 = np.sort(lg, -1)[:, -2:]
    ok = (top2[:, 1] - top2[:, 0]) / T >= 20
    assert ok.sum() >= B // 2
    p = S.probs(_t(lg), torch.full((B,), T), 0, torch.ones(B)).numpy()
    np.testing.assert_array_equal(p[ok].argmax(-1), lg[ok].argmax(-1))
    assert (p[ok].max(-1) > 0.999).all()


# --------------------------------------------------------------------------- #
# Draws on the reference's own noise
# --------------------------------------------------------------------------- #

def _ref_keys(seed, B, tag, sidx=3):
    keys = JS.request_keys(seed, jnp.arange(B, dtype=jnp.int32) * 7 + 1,
                           jnp.full((B,), sidx, jnp.int32))
    return JS.fold_tag(keys, tag)


@pytest.mark.parametrize("V", [33, 1000])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_from_noise_matches_reference_draw(seed, V):
    B = len(TEMPS)
    lg = _logits(seed + 10, B, V, scale=2.0)
    p = JS.probs(jnp.asarray(lg), jnp.asarray(TEMPS), 0, jnp.asarray(TOPPS))
    keys = _ref_keys(seed, B, JS.TAG_DECODE)
    want = np.asarray(JS.draw(p, keys))
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys))
    got = S.draw_from_noise(_t(p), _t(noise)).numpy()
    np.testing.assert_array_equal(got, want)


def _spec_inputs(seed, B, k, V, scale):
    rng = np.random.default_rng(seed)

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    p_d = softmax(scale * rng.standard_normal((B, k, V)))
    p_t = softmax(scale * rng.standard_normal((B, k + 1, V)))
    drafts = np.stack([[rng.choice(V, p=p_d[b, i] / p_d[b, i].sum())
                        for i in range(k)] for b in range(B)]).astype(np.int32)
    # a target that agrees with the drafts here and there, so accept runs
    # of every length occur
    for b in range(B):
        for i in range(k):
            if rng.random() < 0.5:
                p_t[b, i] = p_d[b, i]
    p_d[B - 2:] = 0.0                                 # two undrafted rows
    return drafts, p_d, p_t


@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_reject_sample_matches_reference_on_its_noise(seed, k, greedy):
    B, V = 16, 50
    drafts, p_d, p_t = _spec_inputs(seed, B, k, V, scale=1.5)
    if greedy:                                         # one-hots
        p_d = np.eye(V, dtype=np.float32)[drafts]
        p_t = np.eye(V, dtype=np.float32)[p_t.argmax(-1)]
        p_t[:, :k][np.arange(B) % 3 == 0] = p_d[np.arange(B) % 3 == 0]
        p_d[B - 2:] = 0.0
    ak = _ref_keys(seed, B, JS.TAG_ACCEPT)
    rk = _ref_keys(seed, B, JS.TAG_RESAMPLE)
    n_want, t_want = JSP.reject_sample(jnp.asarray(drafts), jnp.asarray(p_d),
                                       jnp.asarray(p_t), ak, rk)
    u = np.asarray(jax.vmap(lambda key: jax.random.uniform(key, (k,)))(ak))
    noise = np.asarray(jax.vmap(lambda key: jax.random.gumbel(key, (V,)))(rk))
    n_got, t_got = SP.reject_sample_from_noise(
        _t(drafts, torch.int64), _t(p_d), _t(p_t), _t(u), _t(noise))
    np.testing.assert_array_equal(n_got.numpy(), np.asarray(n_want))
    np.testing.assert_array_equal(t_got.numpy(), np.asarray(t_want))
    assert len(set(n_got.tolist())) > 1               # not all one outcome
    assert (n_got[B - 2:] == 0).all()


# --------------------------------------------------------------------------- #
# The port's own noise
# --------------------------------------------------------------------------- #

def _py_lowbias32(x: int) -> int:
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


def test_hash_matches_a_plain_python_model_without_overflow():
    vals = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
            *np.random.default_rng(0).integers(0, 2 ** 32, 200).tolist()]
    x = torch.tensor(vals, dtype=torch.int64)
    for c in (0x7FEB352D, 0x846CA68B, 0xFFFFFFFF):
        assert S._mul32(x, c).tolist() == [(v * c) & 0xFFFFFFFF for v in vals]
    assert S._mix(x).tolist() == [_py_lowbias32(v) for v in vals]
    # every key and word of a draw stays a 32-bit value
    w = S._bits(S._key(2 ** 40 + 5, torch.tensor([0, 2 ** 31 - 1]),
                       torch.tensor([0, 2 ** 31]), S.TAG_RESAMPLE, step=3), 1000)
    assert int(w.min()) >= 0 and int(w.max()) < 2 ** 32


def test_uniforms_lie_in_the_open_interval_and_are_uniform():
    n = 100_000
    u = S.uniform(3, torch.tensor([11]), torch.tensor([0]), S.TAG_ACCEPT, n)[0]
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    hist = np.bincount((u.numpy() * 32).astype(int), minlength=32)
    chi2 = ((hist - n / 32) ** 2 / (n / 32)).sum()
    assert chi2 < CHI2_BOUND, chi2
    g = S.gumbel(3, torch.tensor([11]), torch.tensor([0]), S.TAG_DECODE, n)[0]
    assert abs(float(g.mean()) - 0.5772) < 0.02      # Euler-Mascheroni


@pytest.mark.parametrize("seed", [0, 7])
def test_same_request_draws_identically_in_any_batch(seed):
    V, sidx = 29, 5
    cfg = SamplerConfig(temperature=0.8, seed=seed)
    lg = _t(_logits(seed + 1, 1, V))

    def draw_in_batch(uid, B, row):
        u = torch.full((B,), 999, dtype=torch.int64)
        u[row] = uid
        toks = S.sample(lg.repeat(B, 1), cfg, u, torch.full((B,), sidx),
                        torch.full((B,), 0.8), torch.ones(B))
        return int(toks[row])

    for uid in (0, 3, 12345, 2 ** 30):
        alone = draw_in_batch(uid, 1, 0)
        assert alone == draw_in_batch(uid, 4, 2) == draw_in_batch(uid, 3, 1)


def test_different_uids_and_tags_draw_independently():
    B, V = 64, 64
    lg = _t(0.01 * _logits(0, 1, V)).repeat(B, 1)
    toks = S.sample(lg, SamplerConfig(temperature=1.0), torch.arange(B),
                    torch.zeros(B, dtype=torch.int64), torch.ones(B), torch.ones(B))
    assert len(set(toks.tolist())) > 1
    # uniforms of neighbouring uids, sample indices and tags are uncorrelated
    n = 20_000
    base = S.uniform(0, torch.tensor([5]), torch.tensor([2]), S.TAG_DECODE, n)[0]
    for other in (S.uniform(0, torch.tensor([6]), torch.tensor([2]), S.TAG_DECODE, n),
                  S.uniform(0, torch.tensor([5]), torch.tensor([3]), S.TAG_DECODE, n),
                  S.uniform(0, torch.tensor([5]), torch.tensor([2]), S.TAG_DRAFT, n),
                  S.uniform(1, torch.tensor([5]), torch.tensor([2]), S.TAG_DECODE, n)):
        r = np.corrcoef(base.numpy(), other[0].numpy())[0, 1]
        assert abs(r) < 0.03, r


def test_reject_sample_marginal_matches_target_10k():
    """The port's counterpart of tests/test_spec_decode.py:84, on the port's
    own noise: the first emitted token's marginal is p_t[0] and, given the
    first draft accepted, the second's is p_t[1]."""
    V, k, n = 32, 3, 10_000
    rng = np.random.default_rng(42)

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    p_d = torch.from_numpy(softmax(1.5 * rng.standard_normal((k, V))))
    p_t = torch.from_numpy(softmax(1.5 * rng.standard_normal((k + 1, V))))
    uids, sidx = torch.arange(n), torch.zeros(n, dtype=torch.int64)
    drafts = torch.stack([S.draw_from_noise(
        p_d[i].expand(n, V), S.gumbel(7, uids, sidx, S.TAG_DRAFT, V, step=i))
        for i in range(k)], 1)
    n_acc, toks = SP.reject_sample(drafts, p_d.expand(n, k, V),
                                   p_t.expand(n, k + 1, V), 7, uids, sidx)
    assert ((0 <= n_acc) & (n_acc <= k)).all()

    def chi2(sample, p):
        hist = np.bincount(sample, minlength=V)
        want = p.numpy() * len(sample)
        return ((hist - want) ** 2 / want).sum()

    assert chi2(toks[:, 0].numpy(), p_t[0]) < CHI2_BOUND
    sel = (n_acc >= 1).numpy()
    assert sel.sum() > 500
    assert chi2(toks[sel, 1].numpy(), p_t[1]) < CHI2_BOUND
