"""Mamba2 SSD (state-space duality) mixer [arXiv:2405.21060]: the port of
``repro.models.ssm``.

Prefill takes the chunked SSD algorithm (a quadratic block inside each
chunk, a state recurrence between chunks) when the chunk divides the
sequence, else the sequential recurrence, as the JAX package does; decode
is the O(1) recurrent step. The JAX ``lax.scan``s become Python loops over
chunks (``ssd_chunked``) or steps (``ssd_sequential``). Everything here is
plain PyTorch: the JAX package has no TPU kernel behind it.

Layout: x [B, L, H, P], B/C [B, L, G, N], dt [B, L, H]; state [B, H, P, N]
in f32; the conv state holds the last ``conv_width - 1`` pre-conv inputs
``xbc_raw`` in the activation dtype. Decode writes both states into the
cache it is given (in place) and returns it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear, rms_norm


def init_ssm_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    h, n, g = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    conv_dim = din + 2 * g * n
    dt = cfg.activation_dtype
    dev = gen.device
    f32 = torch.float32
    return {
        "w_in": dense_init(gen, (d, 2 * din + 2 * g * n + h), dtype=dt),
        "w_out": dense_init(gen, (din, d), dtype=dt),
        "conv_w": dense_init(gen, (cfg.conv_width, conv_dim), dtype=dt),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=dev)),
        "D": torch.ones((h,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=f32, device=dev),
        "norm": torch.zeros((din,), dtype=dt, device=dev),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv then SiLU. x [B, L, C], w [W, C]."""
    width, length = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + length] * w[i][None, None, :] for i in range(width))
    return F.silu(out)


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    din, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * g * n]
    dt = zxbcdt[..., 2 * din + 2 * g * n:]
    return z, xbc, dt


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., Q] -> lower-triangular pairwise segment sums [..., Q, Q];
    ``-inf`` above the diagonal, so ``exp`` gives exactly 0 there."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a_log, b_mat, c_mat, chunk: int, h0=None):
    """Chunked SSD -> (y [B,L,H,P] in x's dtype, final state [B,H,P,N]
    f32). x [B,L,H,P]; dt [B,L,H] (after softplus); a_log [H] (A =
    -exp(a_log)); b_mat / c_mat [B,L,G,N] with H % G == 0; the chunk must
    divide L. The JAX package's 4-operand einsum of the diagonal block is
    taken as ``(C . B) * decay`` and then the product with ``x * dt``, its
    3-operand ones as two products: the same sums in another order, so the
    results agree to rounding, not bit for bit."""
    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    q = min(chunk, length)
    nc = length // q
    assert nc * q == length, f"seq {length} not divisible by chunk {q}"
    f32 = torch.float32

    a = -torch.exp(a_log.to(f32))                                # [H]
    dt = dt.to(f32)
    da = dt * a[None, None, :]                                   # [B,L,H]
    xr = x.reshape(bsz, nc, q, h, p)
    dtr = dt.reshape(bsz, nc, q, h)
    dar = da.reshape(bsz, nc, q, h)
    br = torch.repeat_interleave(b_mat.reshape(bsz, nc, q, g, n), rep,
                                 dim=3).to(f32)                  # [B,nc,Q,H,N]
    cr = torch.repeat_interleave(c_mat.reshape(bsz, nc, q, g, n), rep,
                                 dim=3).to(f32)
    da_cs = torch.cumsum(dar, dim=2)                             # [B,nc,Q,H]

    # the diagonal block: inside each chunk
    decay = torch.exp(_segsum(dar.permute(0, 1, 3, 2)))          # [B,nc,H,Q,K]
    xdt = (xr * dtr[..., None].to(x.dtype)).to(f32)
    cb = torch.einsum("bcqhn,bckhn->bchqk", cr, br)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", cb * decay, xdt)

    # each chunk's input state
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)        # [B,nc,Q,H]
    states = torch.einsum("bckhn,bckhp->bchpn",
                          br * decay_states[..., None], xdt)     # [B,nc,H,P,N]

    # the recurrence between chunks: the state before each chunk
    chunk_decay = torch.exp(da_cs[:, :, -1, :])                  # [B,nc,H]
    carry = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # [B,nc,H,P,N]

    # the carried state's share of each position
    state_decay = torch.exp(da_cs)                               # [B,nc,Q,H]
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", cr, prev_states) \
        * state_decay[..., None]
    y = (y_diag + y_off).reshape(bsz, length, h, p)
    return y.to(x.dtype), carry


def ssd_sequential(x, dt, a_log, b_mat, c_mat, h0=None):
    """The per-step recurrence (the sequential oracle, and prefill's path
    where the chunk does not divide the sequence) -> (y [B,L,H,P] in x's
    dtype, final state [B,H,P,N] f32)."""
    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    xf, dtf = x.to(f32), dt.to(f32)
    bf = torch.repeat_interleave(b_mat, rep, dim=2).to(f32)      # [B,L,H,N]
    cf = torch.repeat_interleave(c_mat, rep, dim=2).to(f32)
    da = torch.exp(dtf * a[None, None])                          # [B,L,H]
    ys = []
    for t in range(length):
        state = state * da[:, t, :, None, None] + torch.einsum(
            "bhp,bh,bhn->bhpn", xf[:, t], dtf[:, t], bf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


# ----------------------------------------------------------------------- #
# Block-level prefill / decode
# ----------------------------------------------------------------------- #
def ssm_prefill(p, x: torch.Tensor, cfg: ModelConfig):
    """x [B,S,d] -> (out [B,S,d], cache = (state [B,H,P,N] f32, conv_state
    [B,W-1,conv_dim]))."""
    bsz, s, _ = x.shape
    din, h, pd = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    g, n, w = cfg.ssm_ngroups, cfg.ssm_state, cfg.conv_width

    z, xbc_raw, dt = _split_proj(linear(p["w_in"], x), cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"])
    xi = xbc[..., :din].reshape(bsz, s, h, pd)
    b_mat = xbc[..., din:din + g * n].reshape(bsz, s, g, n)
    c_mat = xbc[..., din + g * n:].reshape(bsz, s, g, n)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"][None, None])

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk == 0:
        y, state = ssd_chunked(xi, dt, p["A_log"], b_mat, c_mat, chunk)
    else:   # a length the chunk does not divide: the sequential path
        y, state = ssd_sequential(xi, dt, p["A_log"], b_mat, c_mat)
    y = y + xi * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, s, din)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = linear(p["w_out"], y)
    # the conv state: the last (w - 1) pre-conv inputs
    conv_state = (xbc_raw[:, s - (w - 1):] if s >= w - 1
                  else F.pad(xbc_raw, (0, 0, w - 1 - s, 0)))
    return out, (state, conv_state)


def ssm_decode(p, x: torch.Tensor, cache, cfg: ModelConfig):
    """x [B,1,d]; cache = (state [B,H,P,N], conv_state [B,W-1,conv_dim]),
    both written in place with this step's states and returned."""
    bsz = x.shape[0]
    din, h, pd = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    state_c, conv_c = cache
    f32 = torch.float32

    z, xbc_new, dt = _split_proj(linear(p["w_in"], x)[:, 0], cfg)
    window = torch.cat([conv_c.to(xbc_new.dtype), xbc_new[:, None]], dim=1)
    xbc = F.silu(torch.einsum("bwc,wc->bc", window,
                              p["conv_w"].to(x.dtype)))
    xi = xbc[..., :din].reshape(bsz, h, pd)
    b_vec = xbc[..., din:din + g * n].reshape(bsz, g, n)
    c_vec = xbc[..., din + g * n:].reshape(bsz, g, n)
    dt = softplus(dt.to(f32) + p["dt_bias"][None])

    rep = h // g
    b_h = torch.repeat_interleave(b_vec, rep, dim=1)
    c_h = torch.repeat_interleave(c_vec, rep, dim=1)
    a = -torch.exp(p["A_log"].to(f32))
    da = torch.exp(dt * a[None])                                 # [B,H]
    state = state_c.to(f32) * da[..., None, None] + torch.einsum(
        "bhp,bh,bhn->bhpn", xi.to(f32), dt, b_h.to(f32))
    y = torch.einsum("bhpn,bhn->bhp", state, c_h.to(f32)).to(x.dtype)
    y = y + xi * p["D"][None, :, None].to(y.dtype)
    y = y.reshape(bsz, 1, din)
    y = rms_norm(p["norm"], y * F.silu(z)[:, None], cfg.norm_eps)
    out = linear(p["w_out"], y)
    state_c.copy_(state)
    conv_c.copy_(window[:, 1:])
    return out, (state_c, conv_c)
