"""Public entry points for the quantized and attention primitives.

``repro_torch.models`` calls these; each delegates to the backend in scope
(``repro_torch.api.backends.current_backend``: the innermost
``use_backend`` binding, a session's or engine's pin, else the process
default), as ``repro/kernels/ops.py`` does. ``cuda`` launches the
hand-written kernels and refuses tensors off the card; ``ref`` runs the
plain versions on any device. Scales are flattened and broadcast to
``[1, N]`` here, before the backend sees them.
"""
from __future__ import annotations

import torch

from repro_torch.api.backends import current_backend


def _flatten_scale(w_scale, n: int) -> torch.Tensor:
    ws = w_scale.to(torch.float32).reshape(1, -1)
    if ws.shape[1] == 1:
        ws = ws.expand(1, n)
    return ws.contiguous()


def qmatmul_static(x, w_int8, w_scale, act_scale, out_dtype=torch.float32):
    ws = _flatten_scale(w_scale, w_int8.shape[1])
    return current_backend().qmatmul_static(x, w_int8, ws, act_scale,
                                            out_dtype=out_dtype)


def qmatmul_dynamic(x, w_int8, w_scale, out_dtype=torch.float32):
    ws = _flatten_scale(w_scale, w_int8.shape[1])
    return current_backend().qmatmul_dynamic(x, w_int8, ws,
                                             out_dtype=out_dtype)


def qmatmul_packed(x, w_packed, w_scale, act_scale=None,
                   out_dtype=torch.float32):
    """The int8 linear on the packed weight [N, Kp] (``qmatmul.pack_weight``):
    static with ``act_scale``, dynamic without."""
    ws = _flatten_scale(w_scale, w_packed.shape[0])
    if act_scale is None:
        return current_backend().qmatmul_dynamic_packed(
            x, w_packed, ws, out_dtype=out_dtype)
    return current_backend().qmatmul_static_packed(x, w_packed, ws, act_scale,
                                                   out_dtype=out_dtype)


def quantize_weights(w):
    """Per-channel symmetric int8: w [K, N] f32/bf16 -> (w_int8 [K, N],
    scale [1, N] f32)."""
    return current_backend().quantize_weights(w)


def flash_prefill(q, k, v):
    """Fused online-softmax causal prefill attention.

    q [B,S,Hq,hd]; k [B,S,Hkv,hd]; v [B,S,Hkv,dv]. Returns [B,S,Hq,dv] f32.
    Differentiable: under ``cuda``, with grad on, the kernel's forward runs
    in an autograd Function whose backward is the plain
    ``flash_prefill_vjp``; under ``ref`` autograd flows through the plain
    forward. DTensors run on each rank's shard under either."""
    return current_backend().flash_prefill(q, k, v)


def paged_decode(q, k_pool, v_pool, tables, pos):
    """Paged decode attention over fp block pools.

    q [B,Hkv,G,hd]; pools [N,bs,Hkv,hd]; tables [B,M] int32 (-1 =
    unallocated); pos [B] int32. Returns [B,Hkv,G,hd] f32."""
    return current_backend().paged_decode(q, k_pool, v_pool, tables, pos)


def flash_qprefill(q, k_i8, k_s, v_i8, v_s):
    """Fused-dequant causal prefill over int8 K/V.

    q [B,S,Hq,hd]; k_i8 [B,S,Hkv,hd], v_i8 [B,S,Hkv,dv] int8; k_s/v_s
    [B,S,Hkv] f32. Returns [B,S,Hq,dv] f32."""
    return current_backend().flash_qprefill(q, k_i8, k_s, v_i8, v_s)


def qdecode(q, k_i8, k_s, v_i8, v_s, bias):
    """Fused-dequant decode attention over a dense int8 cache.

    q [B,Hkv,G,hd]; k_i8/v_i8 [B,S,Hkv,hd] int8; k_s/v_s [B,S,Hkv] f32;
    bias [B,S] f32 additive. Returns [B,Hkv,G,hd] f32."""
    return current_backend().qdecode(q, k_i8, k_s, v_i8, v_s, bias)


def paged_qdecode(q, k_pool, k_scale, v_pool, v_scale, tables, pos):
    """Paged decode attention over int8 block pools.

    q [B,Hkv,G,hd]; pools [N,bs,Hkv,hd] int8; scale pools [N,bs,Hkv] f32;
    tables [B,M] int32 (-1 = unallocated); pos [B] int32. Returns
    [B,Hkv,G,hd] f32."""
    return current_backend().paged_qdecode(q, k_pool, k_scale, v_pool,
                                           v_scale, tables, pos)


def flash_q4prefill(q, k_i4, k_s, v_i4, v_s):
    """Fused-dequant causal prefill over int4 K/V.

    q [B,S,Hq,hd]; k_i4 [B,S,Hkv,hd//2], v_i4 [B,S,Hkv,dv//2] int8, two
    codes per byte; k_s/v_s [B,S,Hkv,hd//g] / [B,S,Hkv,dv//g] f16 group
    scales (g = 32). Returns [B,S,Hq,dv] f32."""
    return current_backend().flash_q4prefill(q, k_i4, k_s, v_i4, v_s)


def paged_q4decode(q, k_pool, k_scale, v_pool, v_scale, tables, pos):
    """Paged decode attention over int4 block pools.

    q [B,Hkv,G,hd]; pools [N,bs,Hkv,hd//2] int8, two codes per byte; scale
    pools [N,bs,Hkv,hd//g] f16 (g = 32); tables [B,M] int32 (-1 =
    unallocated); pos [B] int32. Returns [B,Hkv,G,hd] f32."""
    return current_backend().paged_q4decode(q, k_pool, k_scale, v_pool,
                                            v_scale, tables, pos)
