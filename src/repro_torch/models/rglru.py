"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427]:
the port of ``repro.models.rglru``.

Recurrence:  r_t = sigmoid(Wa x_t),  i_t = sigmoid(Wx x_t)
             a_t = exp(-c * softplus(lambda) * r_t)
             h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gate projections are block-diagonal (8 blocks). The block: a causal
depthwise conv and the RG-LRU on one branch, a GeLU (tanh form, as
``jax.nn.gelu`` defaults to) gate on the other, multiplied, then projected
out. Prefill's scan over S is a log-step doubling scan (for o = 1, 2, 4,
...: ``u[t] += a[t] * u[t - o]``, ``a[t] *= a[t - o]``), O(log S) launches
where the JAX package takes ``lax.associative_scan``: the same combine in
another tree order, so the states agree to rounding. Decode is the O(1)
step and writes ``h`` and the conv state into the cache it is given (in
place). Prefill returns ``h`` in f32 (the scan's dtype) and decode in the
activation dtype, as the JAX package does. Plain PyTorch: the JAX package
has no TPU kernel behind it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear
from repro_torch.models.ssm import softplus

N_BLOCKS = 8


def init_rglru_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    bw = din // N_BLOCKS
    dt = cfg.activation_dtype
    dev = gen.device
    f32 = torch.float32
    return {
        "w_x": dense_init(gen, (d, din), dtype=dt),
        "w_gate": dense_init(gen, (d, din), dtype=dt),
        "w_out": dense_init(gen, (din, d), dtype=dt),
        "conv_w": dense_init(gen, (cfg.conv_width, din), dtype=dt),
        "wa": dense_init(gen, (N_BLOCKS, bw, bw), in_axis=1, dtype=dt),
        "wi": dense_init(gen, (N_BLOCKS, bw, bw), in_axis=1, dtype=dt),
        "ba": torch.zeros((din,), dtype=f32, device=dev),
        "bi": torch.zeros((din,), dtype=f32, device=dev),
        # a^(1/c) ~ U[0.9, 0.999] at init, as in the paper
        "lam": torch.linspace(0.5, 4.0, din, dtype=f32, device=dev),
    }


def _block_diag(w, x):
    """x [..., din] @ block-diag w [NB, bw, bw] -> [..., din]."""
    lead = x.shape[:-1]
    xb = x.reshape(*lead, N_BLOCKS, -1)
    out = torch.einsum("...nb,nbc->...nc", xb, w.to(x.dtype))
    return out.reshape(*lead, -1)


def _gates(p, x, cfg: ModelConfig):
    """(a [..., din] f32, gated input u [..., din] f32)."""
    f32 = torch.float32
    r = torch.sigmoid(_block_diag(p["wa"], x).to(f32) + p["ba"])
    i = torch.sigmoid(_block_diag(p["wi"], x).to(f32) + p["bi"])
    log_a = -cfg.rglru_c * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    floor = torch.full((), 1e-12, dtype=f32, device=x.device)
    u = torch.sqrt(torch.maximum(1.0 - torch.exp(2.0 * log_a), floor)) * (
        i * x.to(f32))
    return a, u


def rglru_scan(p, x: torch.Tensor, cfg: ModelConfig, h0=None):
    """x [B,S,din] -> (y [B,S,din] in x's dtype, h_final [B,din] f32). A
    given ``h0`` is folded in as a virtual step 0."""
    a, u = _gates(p, x, cfg)
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        u = torch.cat([h0[:, None].to(torch.float32), u], dim=1)
    s = a.shape[1]
    o = 1
    while o < s:
        # (a1, u1) then (a2, u2) -> (a1 * a2, a2 * u1 + u2), every row t
        # combined with row t - o of the previous level
        u = torch.cat([u[:, :o], u[:, o:] + a[:, o:] * u[:, :-o]], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    if h0 is not None:
        u = u[:, 1:]
    return u.to(x.dtype), u[:, -1]


def rglru_block_prefill(p, x: torch.Tensor, cfg: ModelConfig):
    """x [B,S,d] -> (out [B,S,d], cache = (h [B,din] f32, conv_state
    [B,W-1,din]))."""
    s, w = x.shape[1], cfg.conv_width
    xin = linear(p["w_x"], x)                                    # [B,S,din]
    gate = F.gelu(linear(p["w_gate"], x), approximate="tanh")
    xp = F.pad(xin, (0, 0, w - 1, 0))
    conv = sum(xp[:, i:i + s] * p["conv_w"][i][None, None] for i in range(w))
    y, h = rglru_scan(p, conv, cfg)
    out = linear(p["w_out"], y * gate)
    conv_state = (xin[:, s - (w - 1):] if s >= w - 1
                  else F.pad(xin, (0, 0, w - 1 - s, 0)))
    return out, (h, conv_state)


def rglru_block_decode(p, x: torch.Tensor, cache, cfg: ModelConfig):
    """x [B,1,d]; cache = (h [B,din], conv_state [B,W-1,din]), both written
    in place and returned."""
    h_c, conv_c = cache
    xin = linear(p["w_x"], x)[:, 0]                              # [B,din]
    gate = F.gelu(linear(p["w_gate"], x), approximate="tanh")[:, 0]
    window = torch.cat([conv_c.to(xin.dtype), xin[:, None]], dim=1)
    conv = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(x.dtype))
    a, u = _gates(p, conv, cfg)
    h = (a * h_c.to(torch.float32) + u).to(x.dtype)
    out = linear(p["w_out"], (h * gate)[:, None])
    h_c.copy_(h)
    conv_c.copy_(window[:, 1:])
    return out, (h_c, conv_c)
