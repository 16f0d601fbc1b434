"""The arithmetic of the int4-K/V tensor-core flash prefill body, on the CPU.

``csrc/flash_prefill.cu``'s ``flash_q4tc`` runs only on a card. Its numerics
are emulated here in plain PyTorch: nibble codes fed to the bf16 tensor
cores unchanged (every code in [-8, 7] is exact in bf16), BK-key tiles (64
in the default tile; every instantiated BK is emulated too), one
score accumulator per group of 32 K columns multiplied by the key's f16
group scale in f32 before it joins the score, then / sqrt(hd); an online
softmax; for each group of 32 V columns the scale folded into p per key,
p'_g = p * s_v[key, g], split into two bf16 terms for the value product over
the codes, the normalizer summing p; f32 q split once into two bf16 terms.
The emulation is held to the JAX Pallas kernel in interpret mode and to the
port's ``flash_q4prefill_ref`` on the same numpy inputs. A code times its
f16 scale needs up to 15 significand bits, so one bf16 tile of dequantized
K misses the same tolerance, as does one bf16 term of p' or of f32 q: that
is why the kernel keeps the scales in f32 and splits both. The nibble
conversion's constants are read from the CUDA source; the tiles are
``autotune.TILES``, which ``test_torch_autotune.py`` holds to it. The card
kernel itself is held to ``flash_q4prefill_ref`` in ``test_torch_cuda.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill import (INTERPRET_MAX_SEQ,  # noqa: E402
                                         flash_q4prefill_attention)
from repro_torch.kernels import autotune, flash_prefill  # noqa: E402
from repro_torch.kernels.quantize import (KV_GROUP,  # noqa: E402
                                          unpack_int4)
from repro_torch.kernels.ref import (NEG_INF, RUN_INIT,  # noqa: E402
                                     flash_q4prefill_ref)

CU = Path(flash_prefill.__file__).resolve().parents[1] / "csrc" / \
    "flash_prefill.cu"


def _tc_constants():
    """Every ``constexpr int NAME = expr;`` of the tensor-core namespace,
    evaluated in order."""
    env = {}
    tc = CU.read_text().split("namespace tc {", 1)[1].split(
        "}  // namespace tc", 1)[0]
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", tc,
                                 flags=re.M):
        env[name] = int(eval(expr, {}, dict(env)))
    return env


TC = _tc_constants()
# the default tile's query rows and keys; every BK the int4 body
# instantiates in some width class
BR, BK = autotune.DEFAULT_TILE
BKS = sorted({bk for w in (64, 96, 128)
              for _, bk in autotune.tiles("q4tc", w)})
ATOL = 1e-4                  # the card kernel's tolerance (INT8KV_ATOL)

# (b, hq, hkv, hd, dv, s): G 1 and 4, hd / dv among 32..128, S not a
# multiple of 64; S <= INTERPRET_MAX_SEQ so interpret mode runs _q4_kernel
# (which sizes the V scales' blocks by hd's groups, so dv = hd there)
Q4_CASES = [(1, 4, 4, 64, 64, 130),
            (1, 8, 2, 128, 128, 200),
            (2, 4, 1, 96, 96, 77),
            (1, 2, 2, 32, 32, 256),
            (1, 8, 2, 32, 32, 65)]
# hd != dv, held to the plain version only
Q4_MIXED = [(2, 4, 1, 96, 32, 77), (1, 8, 2, 32, 128, 129)]


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _heads(x, g):
    """[B,S,Hkv*g,D] -> [B,Hkv,S*g,D]: rows r = s * g + g' per kv head."""
    b, s, h, d = x.shape
    x = x.reshape(b, s, h // g, g, d).permute(0, 2, 1, 3, 4)
    return x.reshape(b, h // g, s * g, d)


def q4tc_emulate(q, k_i4, k_s, v_i4, v_s, p_terms=2, q_terms=2,
                 k_dequant_bf16=False, bk=BK):
    """q [B,S,Hq,hd] bf16 or f32; packed codes k [B,S,Hkv,hd/2] / v
    [B,S,Hkv,dv/2]; f16 group scales k_s [B,S,Hkv,hd/32] / v_s
    [B,S,Hkv,dv/32] -> [B,S,Hq,dv] f32, as ``flash_q4tc`` computes it: rows
    r = s * G + g per kv head, bk-key tiles, per group of 32 K columns
    (q . codes) * s_k summed over groups, / sqrt(hd), masked with NEG_INF,
    running max from RUN_INIT; for each group of 32 V columns O += hi.V +
    lo.V over p' = p * s_v = hi + lo (``p_terms=1``: hi alone) while l sums
    p. f32 q: hi.codes + lo.codes (``q_terms=1``: hi alone).
    ``k_dequant_bf16``: instead, one bf16 tile of dequantized K (code * s_k
    rounded to bf16) and no scale after the dot."""
    b, s, hq, hd = q.shape
    hkv, dv = k_i4.shape[2], v_i4.shape[3] * 2
    g = hq // hkv
    qf = _heads(q.float(), g)
    q_parts = (_split(qf) if q.dtype == torch.float32 else (qf,))[:q_terms]
    kc = _bf16(unpack_int4(k_i4).float()).permute(0, 2, 1, 3)   # exact
    vc = _bf16(unpack_int4(v_i4).float()).permute(0, 2, 1, 3)
    ks = k_s.float().permute(0, 2, 1, 3)             # [B,Hkv,S,ngk]
    vs = v_s.float().permute(0, 2, 1, 3)
    if k_dequant_bf16:
        kd = _bf16(kc * ks.repeat_interleave(KV_GROUP, dim=-1))
    qpos = torch.arange(s * g) // g
    m = torch.full((b, hkv, s * g, 1), RUN_INIT)
    den = torch.zeros((b, hkv, s * g, 1))
    acc = torch.zeros((b, hkv, s * g, dv))
    scale = torch.sqrt(torch.tensor(float(hd)))
    for k0 in range(0, s, bk):
        keys = slice(k0, k0 + bk)
        if k_dequant_bf16:
            sc = sum(part @ kd[:, :, keys].transpose(-1, -2)
                     for part in q_parts)
        else:
            sc = torch.zeros((b, hkv, s * g, kc[:, :, keys].shape[2]))
            for c in range(hd // KV_GROUP):
                cols = slice(c * KV_GROUP, (c + 1) * KV_GROUP)
                dot = sum(part[..., cols] @ kc[:, :, keys, cols]
                          .transpose(-1, -2) for part in q_parts)
                sc = sc + dot * ks[:, :, None, keys, c]
        sc = sc / scale
        kp = torch.arange(k0, k0 + sc.shape[-1])
        sc = torch.where(kp[None, :] <= qpos[:, None], sc,
                         torch.tensor(NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for c in range(dv // KV_GROUP):
            cols = slice(c * KV_GROUP, (c + 1) * KV_GROUP)
            pv = p * vs[:, :, None, keys, c]
            hi = _bf16(pv)
            acc[..., cols] += hi @ vc[:, :, keys, cols]
            if p_terms == 2:
                acc[..., cols] += _bf16(pv - hi) @ vc[:, :, keys, cols]
        m = m_new
    out = (acc / den).reshape(b, hkv, s, g, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, hq, dv)


def _inputs(b, hq, hkv, hd, dv, s, dtype=torch.bfloat16):
    """q of order 1; packed bytes over every nibble -8..7 and f16 group
    scales of order 1/7 (dequantized K/V of order 1, as int4 K/V are)."""
    rng = np.random.default_rng(b * 1000 + hq * 100 + hd + dv + s)
    q = rng.normal(size=(b, s, hq, hd)).astype(np.float32)

    def codes(w):
        return rng.integers(-128, 128, (b, s, hkv, w // 2)).astype(np.int8)

    def scales(w):
        return (rng.uniform(0.5, 1.5, (b, s, hkv, w // KV_GROUP))
                / 7).astype(np.float16)

    k_i4, k_s, v_i4, v_s = codes(hd), scales(hd), codes(dv), scales(dv)
    return (torch.from_numpy(q).to(dtype),
            *(torch.from_numpy(a) for a in (k_i4, k_s, v_i4, v_s)))


def test_tile_constants_are_the_kernels():
    src = CU.read_text()
    assert (BR, BK) == (64, 64) and BKS == [32, 64]
    assert all(autotune.DEFAULT_TILE in autotune.tiles("q4tc", w)
               for w in (64, 96, 128))
    assert TC["NGMAX"] == flash_prefill.MAX_V_DIM // KV_GROUP == 4
    assert "flash_q4tc" in src and "dispatch_q4" in src
    # 2 * BR threads; the 2 BK scale slots of a tile (a key's K and V
    # side) spread over them at any tile
    assert "constexpr int THREADS = 2 * BR;" in src
    assert "constexpr int SLOTS = (2 * BK + THREADS - 1) / THREADS;" in src


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bk", BKS)
def test_q4tc_numerics_at_every_instantiated_bk(bk, dtype):
    """The loop at each BK the body instantiates: where the online softmax
    rescales moves with the tile, and the output stays within ATOL of the
    reference (S 200, G 4: a ragged last tile at every BK)."""
    args = _inputs(1, 8, 2, 128, 128, 200, dtype=dtype)
    got = q4tc_emulate(*args, bk=bk).numpy()
    ref = flash_q4prefill_ref(*args).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_nibble_to_bf16_conversion_is_exact():
    """The conversion pass: nibble c + 8 (the word XOR 0x88888888) under
    0x43 is the bf16 128 + c + 8, and 136 is taken off in bf16 (exact:
    c is representable). Emulated on every byte in both nibble
    positions, with the source's constants."""
    src = " ".join(CU.read_text().split())
    for const in ("0x88888888u", "0x0f0f0f0fu", "0x00ff00ffu",
                  "0x43004300u", "136.f", "0x0400u + 0x0101u * j"):
        assert const in src, const
    byte = np.arange(256, dtype=np.uint32)
    x = byte ^ np.uint32(0x88)
    lo, hi = x & np.uint32(0x0F), (x >> np.uint32(4)) & np.uint32(0x0F)
    pair = lo | (hi << np.uint32(16)) | np.uint32(0x43004300)
    f = np.stack([(pair << np.uint32(16)).view(np.float32),
                  (pair & np.uint32(0xFFFF0000)).view(np.float32)], -1)
    got = f - np.float32(136.0)
    codes = unpack_int4(torch.from_numpy(byte.astype(np.uint8).view(
        np.int8)[:, None])).numpy().astype(np.float32)   # [256, 2]
    assert np.array_equal(got, codes)
    # every code and every difference on the way is a bf16
    assert np.array_equal(_bf16(torch.from_numpy(f)).numpy(), f)
    assert np.array_equal(_bf16(torch.from_numpy(got)).numpy(), got)


def test_every_int4_code_is_exact_in_bf16_but_not_its_dequantized_value():
    codes = torch.arange(-8, 8, dtype=torch.float32)
    assert torch.equal(_bf16(codes), codes)
    # a code times an f16 scale needs up to 15 significand bits
    s = torch.tensor(np.float16(1.0 + 2 ** -10).astype(np.float32))
    assert float(_bf16(7 * s)) != float(7 * s)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", Q4_CASES)
def test_q4tc_numerics_match_pallas_and_ref(case, dtype):
    b, hq, hkv, hd, dv, s = case
    assert s <= INTERPRET_MAX_SEQ
    args = _inputs(*case, dtype=dtype)
    got = q4tc_emulate(*args).numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, k_i4, k_s, v_i4, v_s = args
    pallas = np.asarray(flash_q4prefill_attention(
        jnp.asarray(q.float().numpy(), jdt),
        *(jnp.asarray(t.numpy()) for t in (k_i4, k_s, v_i4, v_s)),
        interpret=True))
    ref = flash_q4prefill_ref(*args).numpy()
    assert got.shape == pallas.shape == ref.shape == (b, s, hq, dv)
    assert np.isfinite(got).all()
    # codes are exact, so are their products with bf16 q terms in f32; the
    # scales multiply in f32; p' is carried to ~2^-17 by two terms, f32 q
    # likewise; the rest is f32 summation order
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", Q4_MIXED)
def test_q4tc_numerics_match_ref_when_hd_and_dv_differ(case, dtype):
    args = _inputs(*case, dtype=dtype)
    np.testing.assert_allclose(q4tc_emulate(*args).numpy(),
                               flash_q4prefill_ref(*args).numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", Q4_CASES)
def test_one_bf16_tile_of_dequantized_k_misses_the_tolerance(case):
    """Why the K scales stay in f32: code * s_g rounded to one bf16 (2^-9
    relative) moves the scores, and so the output, by more than ATOL; the
    per-group accumulators scaled in f32 land well inside it."""
    args = _inputs(*case)
    ref = flash_q4prefill_ref(*args)
    one = float((q4tc_emulate(*args, k_dequant_bf16=True) - ref).abs().max())
    two = float((q4tc_emulate(*args) - ref).abs().max())
    assert one > ATOL
    assert two < ATOL / 5


@pytest.mark.parametrize("case", Q4_CASES)
def test_one_bf16_term_of_p_misses_the_tolerance(case):
    """Why the value product splits p'_g = p * s_v: one bf16 rounding of it
    moves the output by more than ATOL, the two-term split by a small
    fraction of it."""
    args = _inputs(*case)
    ref = flash_q4prefill_ref(*args)
    one = float((q4tc_emulate(*args, p_terms=1) - ref).abs().max())
    two = float((q4tc_emulate(*args, p_terms=2) - ref).abs().max())
    assert one > ATOL
    assert two < ATOL / 5


@pytest.mark.parametrize("case", Q4_CASES)
def test_one_bf16_term_of_f32_q_misses_the_tolerance(case):
    args = _inputs(*case, dtype=torch.float32)
    ref = flash_q4prefill_ref(*args)
    one = float((q4tc_emulate(*args, q_terms=1) - ref).abs().max())
    two = float((q4tc_emulate(*args, q_terms=2) - ref).abs().max())
    assert one > ATOL
    assert two < ATOL / 5


def test_cpu_call_counts_no_body():
    args = _inputs(1, 4, 2, 32, 64, 9)
    before = dict(flash_prefill.flash_q4prefill.launches_by_body)
    flash_prefill.flash_q4prefill(*args)
    flash_prefill.flash_q4prefill(args[0].float(), *args[1:])
    assert flash_prefill.flash_q4prefill.launches_by_body == before
    assert flash_prefill.Q4BODY == {torch.bfloat16: "q4tc",
                                    torch.float32: "q4tc_f32"}
