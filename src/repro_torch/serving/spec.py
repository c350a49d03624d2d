"""Lossless rejection sampling for self-speculative decoding.

The port's counterpart of ``repro/serving/spec.py``. The engine drafts
``k`` tokens a round with a low-bit copy of the weights and verifies them
in one ``(n_slots, k+1)`` target forward; this turns the two
distributions into emitted tokens without changing the output
distribution:

  for i = 1..k:    accept draft d_i with prob  min(1, p_t(d_i)/p_d(d_i))
  on 1st reject:   resample from the residual  max(0, p_t - p_d) / Z
  all accepted:    draw one bonus token from the target's position-k
                   distribution (the residual with p_d := 0)

Under greedy both distributions are one-hots, so a draft is accepted iff
it is the target's argmax and the residual is the target's argmax.

``reject_sample_from_noise`` takes the uniforms and the residual's Gumbel
noise as inputs, so the tests can pass the reference's own draws;
``reject_sample`` draws them from the sampler's counter-based stream.
"""

from __future__ import annotations

import torch

from . import sampler as S


def reject_sample_from_noise(draft_tokens: torch.Tensor,   # (B, k) int64
                             p_draft: torch.Tensor,        # (B, k, V)
                             p_target: torch.Tensor,       # (B, k+1, V)
                             u: torch.Tensor,              # (B, k) uniforms
                             noise: torch.Tensor,          # (B, V) Gumbel
                             ):
    """Returns ``(n_acc (B,), tokens (B, k+1))``: ``n_acc`` leading drafts
    accepted (0..k), ``tokens[:, :n_acc]`` those drafts and
    ``tokens[:, n_acc]`` the residual or bonus draw. Rows with zeroed
    drafter probs (slots that did not draft) accept nothing, and their
    residual is the target's position-0 distribution: a plain decode
    draw."""
    B, k = draft_tokens.shape
    d = draft_tokens[..., None]
    pt_d = torch.gather(p_target[:, :k], -1, d)[..., 0]
    pd_d = torch.gather(p_draft, -1, d)[..., 0]
    # the reference's rule word for word: u * p_d < p_t accepts with
    # probability min(1, p_t / p_d); p_d == 0 rejects
    accept = (u * pd_d < pt_d) & (pd_d > 0)
    n_acc = torch.cumprod(accept.to(torch.int64), dim=-1).sum(-1)
    rows = torch.arange(B, device=draft_tokens.device)
    pt_at = p_target[rows, n_acc]
    pd_at = torch.cat([p_draft, torch.zeros_like(p_draft[:, :1])], 1)[rows, n_acc]
    residual = torch.clamp(pt_at - pd_at, min=0.0)
    z = residual.sum(-1, keepdim=True)
    # z == 0 only when p_t <= p_d pointwise: fall back to p_t
    residual = torch.where(z > 0, residual / torch.clamp(z, min=1e-20), pt_at)
    x = S.draw_from_noise(residual, noise)
    pos = torch.arange(k + 1, device=draft_tokens.device)[None]
    d_pad = torch.cat([draft_tokens, torch.zeros_like(draft_tokens[:, :1])], 1)
    tokens = torch.where(pos < n_acc[:, None], d_pad, x[:, None])
    return n_acc, tokens


def reject_sample(draft_tokens, p_draft, p_target, seed: int, uids, sidx):
    """``reject_sample_from_noise`` on draws of the (seed, uid, sidx)
    stream: uniforms under ``TAG_ACCEPT``, residual noise under
    ``TAG_RESAMPLE``. uids and sidx are (B,) int64 tensors on the
    probabilities' device."""
    k, V = draft_tokens.shape[1], p_target.shape[-1]
    u = S.uniform(seed, uids, sidx, S.TAG_ACCEPT, k)
    noise = S.gumbel(seed, uids, sidx, S.TAG_RESAMPLE, V)
    return reject_sample_from_noise(draft_tokens, p_draft, p_target, u, noise)
