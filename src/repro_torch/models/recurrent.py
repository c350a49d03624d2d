"""Recurrent blocks of the port: RG-LRU (Griffin / RecurrentGemma) and
RWKV6 (Finch).

The port's counterpart of ``repro/models/recurrent.py``. Both are
attention-free token mixers with an O(1) decode state. Their projections
are GEMMs and go through ``layers.dense`` (the plan's kernels: rows 1-3 of
the kernel table); the recurrences are elementwise or small batched
products and stay PyTorch ops, as the reference's are jnp (it has no
Pallas kernel for them).

Sequence processing, with the reference's branch rules:
  RG-LRU  a decode step (S == 1 with a state) is h = a h0 + b; any other
          call runs ``associative_scan``, a replay of
          ``jax.lax.associative_scan``'s odd/even recursion, so the scan
          combines the same pairs in the same order as the reference's.
  RWKV6   the matrix-valued state S_t = diag(w_t) S_{t-1} + k_t^T v_t:
          ``wkv_scan`` (sequential over time: a decode step, or a length
          that is no multiple of the chunk) or ``wkv_chunked`` (intra-chunk
          masked products and a scan over 64-row chunks, when S % 64 == 0).

Every op rounds where the reference's does: the sigmoid as 1 / (1 +
exp(-x)), softplus as ``logaddexp(x, 0)`` = max(x, 0) + log1p(exp(-|x|)),
the tanh form of gelu (``layers._gelu_tanh``), and the ``1e-6`` clip under
the input normalisation's square root. Dtypes follow the reference's
promotion: a bf16 parameter times an f32 activation computes in f32, a
Python scalar times a bf16 parameter stays bf16.

The recurrences' ops (everything of a block but its dense projections)
run inside ``torch.profiler.record_function`` ranges named
``RECURRENCE_RANGES``, so a profile can sum their device time apart from
the GEMMs'.

States (one row per sequence; the engine keeps one per slot):
  RG-LRU  {"h": (B, R) f32, "conv": (B, cw - 1, R) in the activation dtype}
  RWKV6   {"s": (B, H, hd, hd) f32, "shift_t": (B, 1, D), "shift_c": (B, 1, D)}
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from .layers import _gelu_tanh, dense, norm_apply

_C_RGLRU = 8.0  # Griffin's fixed recurrence-gate temperature
WKV_CHUNK = 64  # wkv_chunked's chunk (the reference's default)
RWKV_LORA = 32  # the rank of the data-dependent mixes (reference ``Ld``)
RECURRENCE_RANGES = ("rglru.recurrence", "rwkv.recurrence")


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid as XLA lowers it: 1 / (1 + exp(-x)), op by op."""
    return 1 / (1 + torch.exp(-x))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus = logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * _sigmoid(x)


# --------------------------------------------------------------------------- #
# RG-LRU
# --------------------------------------------------------------------------- #

def associative_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The first-order recurrence h_t = a_t h_{t-1} + b_t along axis 1, by
    ``jax.lax.associative_scan``'s recursion with the combine (al, bl) .
    (ar, br) = (al ar, ar bl + br): adjacent pairs combined, the odd
    elements scanned by recursion, each even element (but the first)
    combined from the odd one before it, the two interleaved. Each combine
    rounds its product and sum on their own, as the reference's eager ops
    do. Returns the h of every step."""
    return _scan(a, b)[1]


def _scan(a: torch.Tensor, b: torch.Tensor):
    n = a.shape[1]
    if n < 2:
        return a, b
    al, bl = a[:, 0:n - 1:2], b[:, 0:n - 1:2]
    ar, br = a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _scan(al * ar, ar * bl + br)
    if n % 2 == 0:
        pa, pb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        pa, pb = odd_a, odd_b
    ea, eb = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], pa * ea], dim=1)
    even_b = torch.cat([b[:, :1], ea * pb + eb], dim=1)
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[:, 0::2], out_b[:, 0::2] = even_a, even_b
    out_a[:, 1::2], out_b[:, 1::2] = odd_a, odd_b
    return out_a, out_b


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. x (B, S, R); w (cw, R); ``state``
    (B, cw - 1, R) the previous segment's trailing inputs (zeros when
    None). Returns (out, new state): the terms summed from 0 in tap order,
    in x's dtype, as the reference's Python ``sum``."""
    cw = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], cw - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (B, S + cw - 1, R)
    S = x.shape[1]
    out = 0
    for i in range(cw):
        out = out + xp[:, i:i + S] * w[i]
    out = out + b
    new_state = xp[:, xp.shape[1] - (cw - 1):] if cw > 1 else state
    return out.to(x.dtype), new_state


def _rglru_gates(p: dict, u: torch.Tensor):
    """(a, the normalised input b) of the RG-LRU from u (f32)."""
    r = _sigmoid(u * p["lru_rec_w"] + p["lru_rec_b"])
    i = _sigmoid(u * p["lru_in_w"] + p["lru_in_b"])
    log_a = -_C_RGLRU * _softplus(p["lru_a"]) * r           # log a_t <= 0
    a = torch.exp(log_a)
    # Griffin's normalized input: sqrt(1 - a^2), clipped for stability
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * i * u


def rglru_apply(p: dict, x: torch.Tensor, *, cfg,
                state: Optional[dict] = None):
    """x (B, S, D) -> (y (B, S, D), new state {"h", "conv"}). ``state``
    None starts from zeros; a state with S == 1 is a decode step."""
    pol = cfg.quant
    u = dense(p["w_rnn_in"], x, tag="rnn.w_in", policy=pol)
    g = dense(p["w_rnn_gate"], x, tag="rnn.w_gate", policy=pol)
    with record_function(RECURRENCE_RANGES[0]):
        u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"],
                                   state["conv"] if state is not None else None)
        a, b = _rglru_gates(p, u.float())                    # (B, S, R) each
        h0 = state["h"].float() if state is not None else None
        if x.shape[1] == 1 and state is not None:            # decode step
            h = a[:, 0] * h0 + b[:, 0]
            hs = h[:, None]
        else:
            if h0 is not None:
                b = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
            hs = associative_scan(a, b)
            h = hs[:, -1]
        out = hs.to(x.dtype) * _gelu_tanh(g)
    y = dense(p["w_rnn_out"], out, tag="rnn.w_out", policy=pol)
    return y, {"h": h, "conv": new_conv}


def rglru_state_init(cfg, batch: int, dtype, device) -> dict:
    R = cfg.d_rnn or cfg.d_model
    return {"h": torch.zeros((batch, R), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, R), dtype=dtype,
                                device=device)}


# --------------------------------------------------------------------------- #
# RWKV6
# --------------------------------------------------------------------------- #

def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """x (B, S, D) shifted right by one row, ``prev`` (B, 1, D) the previous
    segment's last row (zeros when None); returns (shifted, x's last row)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1), x[:, -1:]


def wkv_scan(r, k, v, w, u, s0):
    """The sequential WKV: r, k, v, w (B, S, H, hd), w the decays in (0, 1);
    u (H, hd) the bonus; s0 (B, H, hd, hd). Returns (out (B, S, H, hd),
    the final state)."""
    s = s0
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t, s + u[None, :, :, None] * kv))
        s = w_t[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv_chunked(r, k, v, w, u, s0, *, chunk: int = WKV_CHUNK):
    """The block-parallel WKV: intra-chunk terms as causally masked
    products, the state carried across chunks by a scan; ``wkv_scan``
    where S is no multiple of ``chunk``. Equal to ``wkv_scan`` up to f32
    rounding."""
    B, S, H, hd = r.shape
    if S % chunk:
        return wkv_scan(r, k, v, w, u, s0)
    n = S // chunk
    rc, kc, vc, wc = (t.reshape(B, n, chunk, H, hd) for t in (r, k, v, w))
    lw = torch.log(torch.clamp(wc, min=1e-8))                # (B, n, L, H, hd)
    cum = torch.cumsum(lw, dim=2)                            # inclusive
    r_ = rc * torch.exp(cum - lw)                            # exp(c_{i-1})
    k_ = kc * torch.exp(-cum)                                # exp(-c_i)
    A = torch.einsum("bnihd,bnjhd->bnhij", r_, k_)           # (B, n, H, L, L)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    A = torch.where(mask, A, torch.zeros((), dtype=A.dtype, device=A.device))
    intra = torch.einsum("bnhij,bnjhd->bnihd", A, vc)
    diag = torch.einsum("bnihd,bnihd->bnih", rc, u[None, None, None] * kc)
    intra = intra + diag[..., None] * vc
    decay_tot = torch.exp(cum[:, :, -1])                     # (B, n, H, hd)
    kv_chunk = torch.einsum("bnihd,bnihe->bnhde",
                            kc * torch.exp(cum[:, :, -1:] - cum), vc)
    s = s0
    inter = []
    for i in range(n):
        inter.append(torch.einsum("bihd,bhde->bihe", r_[:, i], s))
        s = decay_tot[:, i][..., None] * s + kv_chunk[:, i]
    inter = torch.stack(inter, dim=1)                        # (B, n, L, H, hd)
    return (intra + inter).reshape(B, S, H, hd), s


def rwkv_apply(p: dict, x: torch.Tensor, *, cfg,
               state: Optional[dict] = None):
    """A whole RWKV6 layer, time mix then channel mix, each owning its
    residual. x (B, S, D) -> (y, new state {"s", "shift_t", "shift_c"}).
    A decode step (S == 1 with a state) runs ``wkv_scan``; otherwise
    ``wkv_chunked`` (the reference's default impl), which takes the scan
    where S % 64."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_size
    H = D // hd
    pol = cfg.quant

    # time mix (pre-norm; the token shift runs on the normed stream)
    xn = norm_apply(p["ln1"], x, "layernorm")
    with record_function(RECURRENCE_RANGES[1]):
        xs, last_t = _token_shift(xn, state["shift_t"] if state else None)
        lora = torch.tanh(xn @ p["mix_lora_a"])              # (B, S, Ld)
        mixes = p["mix_x"][:, None, None] + torch.einsum(
            "bsl,cld->cbsd", lora, p["mix_lora_b"])          # (5, B, S, D)
        xr, xk, xv, xg, xw = [xn + (xs - xn) * _sigmoid(mixes[c]) for c in range(5)]
    r = dense(p["w_r"], xr, tag="rwkv.w_r", policy=pol)
    k = dense(p["w_k"], xk, tag="rwkv.w_k", policy=pol)
    v = dense(p["w_v"], xv, tag="rwkv.w_v", policy=pol)
    g = dense(p["w_g"], xg, tag="rwkv.w_g", policy=pol)
    with record_function(RECURRENCE_RANGES[1]):
        dl = torch.tanh(xw @ p["decay_lora_a"]) @ p["decay_lora_b"]
        w = torch.exp(-torch.exp((p["decay_w"] + dl).float()))  # (B, S, D) in (0, 1)

        rh, kh, vh, wh = (t.reshape(B, S, H, hd).float() for t in (r, k, v, w))
        u = p["bonus_u"].reshape(H, hd).float()
        s0 = state["s"].float() if state is not None else \
            torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        if S == 1 and state is not None:
            out, s_fin = wkv_scan(rh, kh, vh, wh, u, s0)
        else:
            out, s_fin = wkv_chunked(rh, kh, vh, wh, u, s0)

        # per-head group norm
        mu = out.mean(-1, keepdim=True)
        var = ((out - mu) ** 2).mean(-1, keepdim=True)
        out = (out - mu) * torch.rsqrt(var + 1e-5)
        out = out.reshape(B, S, D) * p["ln_scale"].float()
        out = (out * _silu(g.float())).to(x.dtype)
    x = x + dense(p["w_out"], out, tag="rwkv.w_out", policy=pol)

    # channel mix
    xn2 = norm_apply(p["ln2"], x, "layernorm")
    xs2, last_c = _token_shift(xn2, state["shift_c"] if state else None)
    xk2 = xn2 + (xs2 - xn2) * _sigmoid(p["mix_x"][0])        # slot 0's mix
    kk = torch.square(torch.relu(dense(p["wc_k"], xk2, tag="rwkv.wc_k", policy=pol)))
    vv = dense(p["wc_v"], kk, tag="rwkv.wc_v", policy=pol)
    rr = _sigmoid(dense(p["wc_r"], xk2, tag="rwkv.wc_r", policy=pol))
    return x + rr * vv, {"s": s_fin, "shift_t": last_t, "shift_c": last_c}


def rwkv_state_init(cfg, batch: int, dtype, device) -> dict:
    D, hd = cfg.d_model, cfg.rwkv_head_size
    H = D // hd
    return {"s": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
            "shift_t": torch.zeros((batch, 1, D), dtype=dtype, device=device),
            "shift_c": torch.zeros((batch, 1, D), dtype=dtype, device=device)}


def state_init(cfg, layer_type: str, batch: int, dtype, device) -> dict:
    """A recurrent layer's zero state for ``batch`` rows, keyed as the
    reference's cache tree: {"rnn": ...} or {"rwkv": ...}."""
    if layer_type == "recurrent":
        return {"rnn": rglru_state_init(cfg, batch, dtype, device)}
    return {"rwkv": rwkv_state_init(cfg, batch, dtype, device)}
