"""Plain PyTorch versions of the ported kernels (same names and positional
arity as the JAX oracles in ``repro.kernels.ref``).

They run on any device. The kernel wrappers take them for CPU tensors, the
CPU tests hold them against the JAX kernels, and ``chip_smoke.py`` holds
the CUDA kernels against them on the card.

Rounding is part of the contract. Codes round half to even
(``torch.round``), and every constant divides as a same-device tensor:
``127.0 / t`` in PyTorch is ``t.reciprocal() * 127`` and ``t / 127.0`` on
CUDA multiplies by the reciprocal, and either can move a .5 quotient to
the other int8 code.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.quantize import quantize_tensor
from repro_torch.kernels.quantize import dequantize_kv_int4, quantize_kv_int4

NEG_INF = -2.0e38


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _int8_dot(a_codes: torch.Tensor, b_codes: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> integer product, returned as f32 (as the JAX
    ``int32 -> f32`` cast rounds). float64 holds every partial sum exactly
    below 2**53, i.e. for any K < 5.5e11, on every device."""
    return torch.matmul(a_codes.to(torch.float64),
                        b_codes.to(torch.float64)).to(torch.float32)


def quantize_ref(w):
    """Per-channel symmetric int8 weight quantization, w [K, N] -> (codes
    int8 [K, N], scale f32 [1, N]): ``round(w * (127 / absmax))`` clipped to
    +-127 and ``absmax / 127``, absmax over K floored at 1e-12. The artifact
    path's ``quantize_tensor`` computes exactly this, so it is the plain
    version."""
    q = quantize_tensor(w)
    return q["w_int8"], q["scale"]


def quantize_rows_ref(x):
    """Dynamic per-row activation quantization: (codes int8 [M,K],
    a_scale f32 [M,1]) with ``round(x * (127 / absmax))`` clipped to
    +-127 and ``a_scale = absmax / 127``."""
    xf = x.to(torch.float32)
    absmax = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-12)
    inv = _const(127.0, xf) / absmax
    codes = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return codes, absmax / _const(127.0, xf)


def quantize_static_ref(x, act_scale):
    """Static activation quantization: ``round(x * (1 / act_scale))``
    clipped to +-127 (``repro.kernels.qmatmul`` multiplies by the
    reciprocal, so this does too)."""
    xf = x.to(torch.float32)
    a = torch.as_tensor(act_scale, dtype=torch.float32, device=xf.device)
    inv = _const(1.0, xf) / a
    return torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)


def qmatmul_static_ref(x, w_int8, w_scale, act_scale, *,
                       out_dtype=torch.float32):
    """Static w8a8: x [M,K] float; w_int8 [K,N]; w_scale [1,N]; act_scale
    scalar. Epilogue ``acc * (act_scale * w_scale)``, in f32, then cast to
    ``out_dtype``."""
    codes = quantize_static_ref(x, act_scale)
    a = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device)
    return (_int8_dot(codes, w_int8)
            * (a * w_scale.to(torch.float32))).to(out_dtype)


def qmatmul_dynamic_ref(x, w_int8, w_scale, *, out_dtype=torch.float32):
    """Dynamic w8a8: per-row activation scale computed at run time.
    Epilogue ``(acc * a_scale) * w_scale``, the order of the TPU kernel
    (``repro.kernels.dynquant._kernel``), in f32, then cast to
    ``out_dtype``."""
    codes, a_scale = quantize_rows_ref(x)
    return (_int8_dot(codes, w_int8) * a_scale
            * w_scale.to(torch.float32)).to(out_dtype)


def _packed_dot(codes, w_packed):
    """codes [M, K] against the K-major packed weight [N, Kp] (zero K
    tail): the same integer sums as ``_int8_dot(codes, w_int8)``."""
    pad = w_packed.shape[1] - codes.shape[1]
    return _int8_dot(torch.nn.functional.pad(codes, (0, pad)), w_packed.t())


def qmatmul_static_packed_ref(x, w_packed, w_scale, act_scale, *,
                              out_dtype=torch.float32):
    """``qmatmul_static_ref`` on the packed weight [N, Kp]."""
    codes = quantize_static_ref(x, act_scale)
    a = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device)
    return (_packed_dot(codes, w_packed)
            * (a * w_scale.to(torch.float32))).to(out_dtype)


def qmatmul_dynamic_packed_ref(x, w_packed, w_scale, *,
                               out_dtype=torch.float32):
    """``qmatmul_dynamic_ref`` on the packed weight [N, Kp]."""
    codes, a_scale = quantize_rows_ref(x)
    return (_packed_dot(codes, w_packed) * a_scale
            * w_scale.to(torch.float32)).to(out_dtype)


def flash_prefill_ref(q, k, v):
    """Causal softmax attention from position 0, in f32.

    q [B,S,Hq,hd]; k [B,S,Hkv,hd]; v [B,S,Hkv,dv] -> [B,S,Hq,dv] f32. GQA
    query head ``h * G + g`` reads kv head ``h``. Scores are
    ``qk / sqrt(hd)`` masked with ``NEG_INF``, as in the TPU kernel."""
    b, s, hq, hd = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    g = hq // hkv
    qg = q.to(torch.float32).reshape(b, s, hkv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(torch.float32))
    scores = scores / torch.sqrt(_const(float(hd), scores))
    pos = torch.arange(s, device=q.device)
    causal = pos[:, None] >= pos[None, :]
    scores = torch.where(causal, scores, _const(NEG_INF, scores))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.to(torch.float32))
    return out.reshape(b, s, hq, dv)


def flash_prefill_vjp(q, k, v, out, dout):
    """(dq, dk, dv) of ``flash_prefill_ref`` at (q, k, v), given its output
    ``out`` [B,S,Hq,dv] and the output's cotangent ``dout``: P recomputed in
    f32 with the forward's scale and ``NEG_INF`` causal mask, ``dS = P *
    (dP - rowsum(dout * out))``; dk and dv are summed over the G query
    heads of each kv head. Each comes back in its input's dtype."""
    b, s, hq, hd = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    g = hq // hkv
    qg = q.to(torch.float32).reshape(b, s, hkv, g, hd)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    do = dout.to(torch.float32).reshape(b, s, hkv, g, dv)
    o = out.to(torch.float32).reshape(b, s, hkv, g, dv)
    sqrt_hd = torch.sqrt(_const(float(hd), qg))
    scores = torch.einsum("bskgh,btkh->bkgst", qg, kf) / sqrt_hd
    pos = torch.arange(s, device=q.device)
    causal = pos[:, None] >= pos[None, :]
    scores = torch.where(causal, scores, _const(NEG_INF, scores))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    d_v = torch.einsum("bkgst,bskgh->btkh", p, do)
    dp = torch.einsum("bskgh,btkh->bkgst", do, vf)
    rows = torch.einsum("bskgh,bskgh->bkgs", do, o)[..., None]
    ds = p * (dp - rows) / sqrt_hd
    d_q = torch.einsum("bkgst,btkh->bskgh", ds, kf).reshape(b, s, hq, hd)
    d_k = torch.einsum("bkgst,bskgh->btkh", ds, qg)
    return d_q.to(q.dtype), d_k.to(k.dtype), d_v.to(v.dtype)


def _dequant(codes, scale):
    """int8 codes [..., hd] * per-row scale [...] -> f32, dequantize first
    (the JAX oracles' order)."""
    return codes.to(torch.float32) * scale.to(torch.float32)[..., None]


def quantize_kv_ref(t):
    """[B,S,H,hd] -> (int8 codes, f32 scale [B,S,H]), per (slot, head):
    ``scale = max(absmax, 1e-8) / 127`` and ``codes = round(t / scale)``
    clipped to +-127, by IEEE division (both constants are same-device
    tensors, so neither becomes a reciprocal multiply)."""
    tf = t.to(torch.float32)
    absmax = tf.abs().amax(dim=-1)
    scale = torch.maximum(absmax, _const(1e-8, tf)) / _const(127.0, tf)
    codes = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def _attend_dense(q, kf, vf, bias):
    """The dense decode oracles' core over dequantized f32 K/V [B,S,Hkv,hd]:
    ``qk / sqrt(hd)``, the additive bias, full-row softmax, normalize p,
    then the value einsum."""
    hd = q.shape[-1]
    scores = torch.einsum("bkgh,bskh->bkgs", q.to(torch.float32), kf)
    scores = scores / torch.sqrt(_const(float(hd), scores))
    scores = scores + bias.to(torch.float32)[:, None, None, :]
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bkgs,bskh->bkgh", p, vf)


def qdecode_ref(q, k_i8, k_s, v_i8, v_s, bias):
    """int8-KV decode attention over a dense cache, in f32.

    q [B,Hkv,G,hd]; k_i8/v_i8 [B,S,Hkv,hd] int8; k_s/v_s [B,S,Hkv] f32;
    bias [B,S] additive (0 or ``NEG_INF``) -> [B,Hkv,G,hd] f32. The JAX
    oracle's order: dequantize, ``qk / sqrt(hd)``, add the bias, full-row
    softmax, normalize p, then the value einsum."""
    return _attend_dense(q, _dequant(k_i8, k_s), _dequant(v_i8, v_s), bias)


def quantize_kv4_ref(t):
    """[B,S,H,hd] -> (packed int4 [B,S,H,hd//2] int8, f16 scale
    [B,S,H,hd//g]): the grouped int4 quantizer of ``kernels.quantize``,
    which owns the layout."""
    return quantize_kv_int4(t)


def q4decode_ref(q, k_i4, k_s, v_i4, v_s, bias):
    """int4-KV decode attention over a dense cache, in f32.

    q [B,Hkv,G,hd]; k_i4/v_i4 [B,S,Hkv,hd//2] packed int8; k_s/v_s
    [B,S,Hkv,hd//g] f16 group scales; bias [B,S] additive -> [B,Hkv,G,hd]
    f32. Dequantize per group (``code * group_scale``), then the core of
    ``qdecode_ref``. The dense int4 decode of the model runs this on every
    device, as the JAX package runs its oracle there."""
    return _attend_dense(q, dequantize_kv_int4(k_i4, k_s),
                         dequantize_kv_int4(v_i4, v_s), bias)


def flash_qprefill_ref(q, k_i8, k_s, v_i8, v_s):
    """int8-KV causal prefill: dequantize per (position, head), then the fp
    prefill. k_i8 [B,S,Hkv,hd], v_i8 [B,S,Hkv,dv] int8; k_s/v_s [B,S,Hkv]
    f32 -> [B,S,Hq,dv] f32."""
    return flash_prefill_ref(q, _dequant(k_i8, k_s), _dequant(v_i8, v_s))


def flash_q4prefill_ref(q, k_i4, k_s, v_i4, v_s):
    """int4-KV causal prefill: dequantize per (position, head, group), then
    the fp prefill. k_i4 [B,S,Hkv,hd//2], v_i4 [B,S,Hkv,dv//2] packed int8;
    k_s/v_s [B,S,Hkv,hd//g] / [B,S,Hkv,dv//g] f16 -> [B,S,Hq,dv] f32."""
    return flash_prefill_ref(q, dequantize_kv_int4(k_i4, k_s),
                             dequantize_kv_int4(v_i4, v_s))


RUN_INIT = -1.0e30      # running-max seed of the online-softmax kernels


def paged_gather(pool, tables):
    """pool [N, bs, ...] + tables [B, M] -> contiguous view [B, M*bs, ...].
    Entries of -1 read block 0 (the reserved trash block) and must be
    masked by the caller (``paged_valid``)."""
    g = pool[tables.clamp(min=0).to(torch.int64)]
    b, m, bs = g.shape[:3]
    return g.reshape((b, m * bs) + tuple(g.shape[3:]))


def paged_valid(tables, pos, block_size: int):
    """[B, M*bs] mask: slot index <= pos AND the covering block is mapped."""
    b, m = tables.shape
    slots = torch.arange(m * block_size, device=tables.device)
    allocated = (tables >= 0).repeat_interleave(block_size, dim=1)
    return (slots[None] <= pos.to(torch.int64)[:, None]) & allocated


def _paged_bias(tables, pos, block_size: int):
    """[B, M*bs] additive mask: 0 where valid, NEG_INF elsewhere."""
    valid = paged_valid(tables, pos, block_size)
    return torch.where(valid, _const(0.0, valid), _const(NEG_INF, valid))


def _attend_paged(q, kf, vf, valid):
    """The paged oracles' core over gathered f32 K/V [B, M*bs, Hkv, hd] and
    the [B, M*bs] validity: masked slots selected away (scores to
    ``NEG_INF``, values to 0), the row max floored at ``RUN_INIT``, then
    ``qk / sqrt(hd)`` softmax, normalize p and the value einsum."""
    hd = q.shape[-1]
    valid = valid[:, None, None, :]
    vf = torch.where(valid[:, 0, 0, :, None, None], vf, _const(0.0, vf))
    scores = torch.einsum("bkgh,bskh->bkgs", q.to(torch.float32), kf)
    scores = scores / torch.sqrt(_const(float(hd), scores))
    scores = torch.where(valid, scores, _const(NEG_INF, scores))
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=RUN_INIT)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bkgs,bskh->bkgh", p, vf)


def paged_decode_ref(q, k_pool, v_pool, tables, pos):
    """Paged decode attention over fp pools, in f32.

    q [B,Hkv,G,hd]; k_pool/v_pool [N,bs,Hkv,hd]; tables [B,M] int32 (-1 =
    unallocated); pos [B] (the write slot, included) -> [B,Hkv,G,hd] f32.
    Gathers the blocks into a contiguous view and runs masked softmax
    attention with scores ``qk / sqrt(hd)``, as the JAX oracle does. Two
    choices make it the kernel's twin on every row:

    * the row max is floored at ``RUN_INIT``, the kernel's running-max
      seed: a row with no valid slot (an idle engine slot: all -1, pos 0)
      then sums to 0 and gives 0/0 = NaN, as the TPU and CUDA kernels do,
      where the JAX oracle would average the trash block;
    * masked slots are selected away (scores to ``NEG_INF``, values to 0)
      instead of biased, so whatever the trash block holds, even NaN
      written there by an idle row, never reaches a live row.

    On every row with a valid slot and finite pools the result is the JAX
    oracle's."""
    return _attend_paged(q, paged_gather(k_pool, tables).to(torch.float32),
                         paged_gather(v_pool, tables).to(torch.float32),
                         paged_valid(tables, pos, k_pool.shape[1]))


def paged_qdecode_ref(q, k_pool, k_scale, v_pool, v_scale, tables, pos):
    """Paged decode attention over int8 pools, in f32.

    q [B,Hkv,G,hd]; k_pool/v_pool [N,bs,Hkv,hd] int8; k_scale/v_scale
    [N,bs,Hkv] f32; tables [B,M] int32; pos [B] -> [B,Hkv,G,hd] f32. The
    JAX oracle gathers codes and scales, dequantizes, and runs the dense
    int8 oracle with the paged bias. Here, as in ``paged_decode_ref``,
    masked slots are selected away (scores to ``NEG_INF``, dequantized
    values to 0) rather than biased, and the row max is floored at
    ``RUN_INIT``: an idle row is 0/0, and a NaN scale or any code that an
    idle row wrote into the trash block never reaches a live row."""
    return _attend_paged(
        q, _dequant(paged_gather(k_pool, tables), paged_gather(k_scale, tables)),
        _dequant(paged_gather(v_pool, tables), paged_gather(v_scale, tables)),
        paged_valid(tables, pos, k_pool.shape[1]))


def paged_q4decode_ref(q, k_pool, k_scale, v_pool, v_scale, tables, pos):
    """Paged decode attention over int4 pools, in f32.

    q [B,Hkv,G,hd]; k_pool/v_pool [N,bs,Hkv,hd//2] packed int8;
    k_scale/v_scale [N,bs,Hkv,hd//g] f16 group scales; tables [B,M] int32;
    pos [B] -> [B,Hkv,G,hd] f32. Gathers codes and scales, dequantizes per
    group and attends as ``paged_qdecode_ref`` does: masked slots are
    selected away, so a NaN scale or any byte that an idle row wrote into
    the trash block never reaches a live row."""
    return _attend_paged(
        q, dequantize_kv_int4(paged_gather(k_pool, tables),
                              paged_gather(k_scale, tables)),
        dequantize_kv_int4(paged_gather(v_pool, tables),
                           paged_gather(v_scale, tables)),
        paged_valid(tables, pos, k_pool.shape[1]))
