"""The arithmetic of the tensor-core flash prefill body, on the CPU.

``csrc/flash_prefill.cu``'s ``flash_tc`` runs only on a card. Its numerics
are emulated here in plain PyTorch: bf16 operands, BK-key tiles (64 in the
default tile; every instantiated BK is emulated too), an online
softmax, the value product over p split into two bf16 terms (hi = bf16(p),
lo = bf16(p - hi)) and f32 accumulation. The emulation is held to the JAX
Pallas kernel in interpret mode and to the port's ``flash_prefill_ref`` on
the same numpy inputs; a single bf16 term of p misses the same tolerance,
which is why the kernel splits it. The card kernel itself is held to
``flash_prefill_ref`` in ``test_torch_cuda.py``.
"""
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill import (INTERPRET_MAX_SEQ,  # noqa: E402
                                         flash_prefill_attention)
from repro_torch.kernels import autotune, flash_prefill  # noqa: E402
from repro_torch.kernels.ref import (NEG_INF, RUN_INIT,  # noqa: E402
                                     flash_prefill_ref)

BK = autotune.DEFAULT_TILE[1]    # keys per K/V tile of the default tile
# every BK the tensor-core body instantiates (either dtype, any class)
BKS = sorted({bk for b in ("tc", "tc_f32") for w in (64, 96, 128)
              for _, bk in autotune.tiles(b, w)})
ATOL = 1e-4      # the card kernel's tolerance against flash_prefill_ref

# (b, hq, hkv, hd, dv, s): G 1 and 4, hd / dv among 32..128, S not a
# multiple of 64; S <= INTERPRET_MAX_SEQ so interpret mode runs _fp_kernel
TC_CASES = [(1, 4, 4, 64, 64, 130),
            (1, 8, 2, 128, 128, 200),
            (2, 4, 1, 96, 48, 77),
            (1, 2, 2, 32, 96, 256),
            (1, 8, 2, 48, 32, 65)]
# the MLA width class <192, 128>: one kv head per query head, hd =
# qk_nope + qk_rope (192 at deepseek-v2's width) beside dv <= 128
MLA_CASES = [(1, 4, 4, 192, 128, 128),
             (2, 2, 2, 160, 96, 70)]


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _mm3(a, b):
    """a @ b over two-term bf16 splits of both: hi.hi + hi.lo + lo.hi."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def tc_emulate(q, k, v, p_terms=2, bk=BK):
    """q [B,S,Hq,hd], k [B,S,Hkv,hd], v [B,S,Hkv,dv] -> [B,S,Hq,dv] f32, as
    ``flash_tc`` computes it: rows r = s * G + g per kv head, bk-key tiles,
    scores q.k / sqrt(hd) masked with NEG_INF, running max from RUN_INIT.
    bf16 inputs: O += hi.V + lo.V over p = hi + lo (``p_terms=1``: hi.V
    alone). f32 inputs: q, k, v and p each split into two bf16 terms, three
    products per matrix product (hi.hi + hi.lo + lo.hi)."""
    f32 = q.dtype == torch.float32
    b, s, hq, hd = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    g = hq // hkv
    qf = q.float().reshape(b, s, hkv, g, hd).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(b, hkv, s * g, hd)
    kf, vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    qpos = torch.arange(s * g) // g
    m = torch.full((b, hkv, s * g, 1), RUN_INIT)
    den = torch.zeros((b, hkv, s * g, 1))
    acc = torch.zeros((b, hkv, s * g, dv))
    scale = torch.sqrt(torch.tensor(float(hd)))
    for k0 in range(0, s, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        qk = _mm3 if f32 else torch.matmul
        sc = qk(qf, kt.transpose(-1, -2)) / scale
        kp = torch.arange(k0, k0 + kt.shape[2])
        sc = torch.where(kp[None, :] <= qpos[:, None], sc,
                         torch.tensor(NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        if f32:
            acc = acc * alpha + _mm3(p, vt)
        else:
            hi = _bf16(p)
            acc = acc * alpha + hi @ vt
            if p_terms == 2:
                acc = acc + _bf16(p - hi) @ vt
        m = m_new
    out = (acc / den).reshape(b, hkv, s, g, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, hq, dv)


def _rn32(x: Fraction) -> np.float32:
    """x rounded once to the nearest f32, ties to even."""
    c = np.float32(float(x))
    cands = [np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf))]
    dist = [abs(Fraction(float(f)) - x) for f in cands]
    best = min(dist)
    tied = [f for f, d in zip(cands, dist) if d == best]
    return min(tied, key=lambda f: int(f.view(np.int32)) & 1)


def _fmaf(a, b, c) -> np.float32:
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def div_by(a, b, rcp):
    """The kernel's quotient a / b (``div_by`` in csrc/flash_prefill.cu):
    q0 = RN(a * rcp), then one FMA correction of the exact residual."""
    q0 = np.float32(a * rcp)
    return _fmaf(_fmaf(-q0, b, a), rcp, q0)


def _inputs(b, hq, hkv, hd, dv, s, dtype=torch.bfloat16):
    rng = np.random.default_rng(b * 1000 + hq * 100 + hd + s)
    shapes = ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, dv))
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(
        dtype) for sh in shapes]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", TC_CASES + MLA_CASES)
def test_tc_numerics_match_pallas_and_ref(case, dtype):
    b, hq, hkv, hd, dv, s = case
    assert s <= INTERPRET_MAX_SEQ
    q, k, v = _inputs(*case, dtype=dtype)
    got = tc_emulate(q, k, v).numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pallas = np.asarray(flash_prefill_attention(
        *(jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v)),
        interpret=True))
    ref = flash_prefill_ref(q, k, v).numpy()
    assert got.shape == pallas.shape == ref.shape == (b, s, hq, dv)
    # bf16: operands exact in f32, p carried to ~2^-17 by its two terms;
    # f32: every operand carried to ~2^-17 by two terms, the lo.lo product
    # (~2^-18) dropped; the rest is f32 summation order
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(pallas, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bk", BKS)
def test_tc_numerics_at_every_instantiated_bk(bk, dtype):
    """The loop at each BK the body instantiates: where the online softmax
    rescales moves with the tile, and the output stays within ATOL of the
    reference (S 200, G 4: a ragged last tile at every BK)."""
    args = _inputs(1, 8, 2, 128, 128, 200, dtype=dtype)
    got = tc_emulate(*args, bk=bk).numpy()
    ref = flash_prefill_ref(*args).numpy()
    assert BKS == [32, 64]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", TC_CASES)
def test_one_bf16_term_of_p_misses_the_tolerance(case):
    """Why the value product splits p: one bf16 rounding of p (relative
    2^-9) moves the output by more than ATOL at the same inputs, the
    two-term split by a small fraction of it."""
    q, k, v = _inputs(*case)
    ref = flash_prefill_ref(q, k, v)
    one = float((tc_emulate(q, k, v, p_terms=1) - ref).abs().max())
    two = float((tc_emulate(q, k, v, p_terms=2) - ref).abs().max())
    assert one > ATOL
    assert two < ATOL / 5


def test_width_classes_and_limits():
    """hd up to 192 with dv up to 128 (the 192 / 128 class, instantiated
    for both dtypes and routed to above hd 128); any other shape raises,
    and the quantized prefills stay at 128 (MLA has no quantized tier)."""
    src = (Path(__file__).parents[1] / "src" / "repro_torch" / "csrc"
           / "flash_prefill.cu").read_text()
    assert "constexpr int MAXD_MLA = 192;" in src
    assert "if (hd > MAXD)\n    return launch_tile<T, MAXD_MLA, MAXD>(" in src
    assert "bad_shape(B, S, Hq, Hkv, hd, dv, MAXD_MLA)" in src
    assert flash_prefill.MAX_HEAD_DIM == 192
    assert flash_prefill.MAX_V_DIM == 128
    assert [flash_prefill.width_class(hd, dv) for hd, dv in (
        (64, 64), (32, 96), (96, 48), (128, 128), (65, 128), (192, 128),
        (129, 64))] == ["64", "96", "96", "128", "128", "192x128", "192x128"]
    assert set(flash_prefill.flash_prefill.launches_by_class) == set(
        flash_prefill.CLASSES)
    q, k, v = _inputs(1, 4, 4, 192, 128, 9)
    assert flash_prefill.flash_prefill(q, k, v).shape == (1, 9, 4, 128)
    for hd, dv in ((193, 128), (192, 129), (128, 160)):
        q, k, v = _inputs(1, 2, 2, hd, dv, 5)
        with pytest.raises(ValueError, match="hd="):
            flash_prefill.flash_prefill(q, k, v)
    q = torch.zeros(1, 5, 2, 192)
    codes = torch.zeros(1, 5, 2, 192, dtype=torch.int8)
    scale = torch.ones(1, 5, 2)
    with pytest.raises(ValueError, match="hd="):
        flash_prefill.flash_qprefill(q, codes, scale, codes, scale)


def test_cpu_call_counts_no_body():
    q, k, v = _inputs(1, 4, 2, 32, 32, 9)
    before = dict(flash_prefill.flash_prefill.launches_by_body)
    flash_prefill.flash_prefill(q, k, v)
    flash_prefill.flash_prefill(q.float(), k.float(), v.float())
    assert flash_prefill.flash_prefill.launches_by_body == before
    assert flash_prefill.BODY == {torch.bfloat16: "tc",
                                  torch.float32: "tc_f32"}


@pytest.mark.parametrize("hd", [32, 40, 48, 64, 96, 128])
def test_three_op_quotient_is_ieee_division(hd):
    """The kernel divides each score by sqrt(hd) as the reference does; its
    three-operation quotient must round as IEEE division: checked exactly
    on scores spread over 2^-20..2^20, both signs, and zero."""
    scale = np.sqrt(np.float32(hd))
    rcp = np.float32(1) / scale
    rng = np.random.default_rng(hd)
    mag = np.exp2(rng.uniform(-20, 20, 3000)) * rng.choice([-1, 1], 3000)
    scores = np.concatenate([mag.astype(np.float32),
                             np.float32([0.0, 1.0, -1.0, scale, 2 * scale])])
    for a in scores:
        assert div_by(a, scale, rcp) == a / scale, (a, hd)
