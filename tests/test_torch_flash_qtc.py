"""The arithmetic of the int8-K/V tensor-core flash prefill body, on the CPU.

``csrc/flash_prefill.cu``'s ``flash_qtc`` runs only on a card. Its numerics
are emulated here in plain PyTorch: int8 codes fed to the bf16 tensor cores
unchanged (every code is exact in bf16), BK-key tiles (64 in the
default tile; every instantiated BK is emulated too), the score
``(q . codes) * k_s / sqrt(hd)`` in the TPU kernel's order, an online
softmax, the V scale folded into p per key (p' = p * v_s) and p' split into
two bf16 terms for the value product over the codes, the normalizer
summing p; f32 q split once into two bf16 terms. The emulation is held to
the JAX Pallas kernel in interpret mode and to the port's
``flash_qprefill_ref`` on the same numpy inputs; one bf16 term of p', or
of f32 q, misses the same tolerance, which is why the kernel splits both.
The tiles are ``autotune.TILES``, which ``test_torch_autotune.py`` holds
to the CUDA source. The card kernel itself is held to
``flash_qprefill_ref`` in ``test_torch_cuda.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill import (INTERPRET_MAX_SEQ,  # noqa: E402
                                         flash_qprefill_attention)
from repro_torch.kernels import autotune, flash_prefill  # noqa: E402
from repro_torch.kernels.ref import (NEG_INF, RUN_INIT,  # noqa: E402
                                     flash_qprefill_ref)

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
# the default tile's query rows and keys; every BK the int8 body
# instantiates in some width class
BR, BK = autotune.DEFAULT_TILE
BKS = sorted({bk for w in (64, 96, 128) for _, bk in autotune.tiles("qtc", w)})
ATOL = 1e-4                  # the card kernel's tolerance (INT8KV_ATOL)

# (b, hq, hkv, hd, dv, s): G 1 and 4, hd / dv among 32..128 (40 and 24:
# the zero-padded widths), S not a multiple of 64; S <= INTERPRET_MAX_SEQ
# so interpret mode runs _q_kernel
QTC_CASES = [(1, 4, 4, 64, 64, 130),
             (1, 8, 2, 128, 128, 200),
             (2, 4, 1, 96, 48, 77),
             (1, 2, 2, 32, 96, 256),
             (1, 8, 2, 40, 24, 65)]


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def qtc_emulate(q, k_i8, k_s, v_i8, v_s, p_terms=2, q_terms=2, bk=BK):
    """q [B,S,Hq,hd] bf16 or f32; codes k [B,S,Hkv,hd] / v [B,S,Hkv,dv]
    int8; scales [B,S,Hkv] f32 -> [B,S,Hq,dv] f32, as ``flash_qtc``
    computes it: rows r = s * G + g per kv head, bk-key tiles, scores
    (q . codes) * k_s / sqrt(hd) masked with NEG_INF, running max from
    RUN_INIT, O += hi.V + lo.V over p' = p * v_s = hi + lo (``p_terms=1``:
    hi alone) while l sums p. f32 q: hi.codes + lo.codes (``q_terms=1``:
    hi alone)."""
    b, s, hq, hd = q.shape
    hkv, dv = k_i8.shape[2], v_i8.shape[3]
    g = hq // hkv
    qf = q.float().reshape(b, s, hkv, g, hd).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(b, hkv, s * g, hd)
    q_parts = _split(qf) if q.dtype == torch.float32 else (qf,)
    q_parts = q_parts[:q_terms]
    kc = _bf16(k_i8.float()).permute(0, 2, 1, 3)     # exact
    vc = _bf16(v_i8.float()).permute(0, 2, 1, 3)
    ks, vs = k_s.permute(0, 2, 1), v_s.permute(0, 2, 1)   # [B,Hkv,S]
    qpos = torch.arange(s * g) // g
    m = torch.full((b, hkv, s * g, 1), RUN_INIT)
    den = torch.zeros((b, hkv, s * g, 1))
    acc = torch.zeros((b, hkv, s * g, dv))
    scale = torch.sqrt(torch.tensor(float(hd)))
    for k0 in range(0, s, bk):
        kt, vt = kc[:, :, k0:k0 + bk], vc[:, :, k0:k0 + bk]
        dot = sum(part @ kt.transpose(-1, -2) for part in q_parts)
        sc = dot * ks[:, :, None, k0:k0 + bk] / scale
        kp = torch.arange(k0, k0 + kt.shape[2])
        sc = torch.where(kp[None, :] <= qpos[:, None], sc,
                         torch.tensor(NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        pv = p * vs[:, :, None, k0:k0 + bk]
        hi = _bf16(pv)
        acc = acc * alpha + hi @ vt
        if p_terms == 2:
            acc = acc + _bf16(pv - hi) @ vt
        m = m_new
    out = (acc / den).reshape(b, hkv, s, g, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, hq, dv)


def _inputs(b, hq, hkv, hd, dv, s, dtype=torch.bfloat16):
    """q of order 1; codes in +-127 and scales of order 1/127 (dequantized
    K/V of order 1, as quantized K/V are)."""
    rng = np.random.default_rng(b * 1000 + hq * 100 + hd + s)
    q = rng.normal(size=(b, s, hq, hd)).astype(np.float32)

    def codes(w):
        return rng.integers(-127, 128, (b, s, hkv, w)).astype(np.int8)

    def scales():
        return (rng.uniform(0.5, 1.5, (b, s, hkv)) / 127).astype(np.float32)

    k_i8, k_s, v_i8, v_s = codes(hd), scales(), codes(dv), scales()
    return (torch.from_numpy(q).to(dtype),
            *(torch.from_numpy(a) for a in (k_i8, k_s, v_i8, v_s)))


def test_every_int8_code_is_exact_in_bf16():
    codes = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(_bf16(codes.float()), codes.float())
    assert torch.equal(codes.to(torch.bfloat16).to(torch.int8), codes)


def test_tile_constant_is_the_kernels():
    src = CU.read_text()
    flat = " ".join(src.split())
    # the emulation's default tile is the kernel's, in every width class
    assert (BR, BK) == (64, 64) and BKS == [32, 64]
    assert all(autotune.DEFAULT_TILE in autotune.tiles("qtc", w)
               for w in (64, 96, 128))
    # 16 query rows a warp: 2 * BR threads; the scale ring's 2 BK slots
    # (a K and a V scale a key) loop over the block's threads at any tile
    assert "constexpr int THREADS = 2 * BR;" in src
    assert "for (int i = threadIdx.x; i < 2 * BK; i += THREADS)" in flat
    assert TC["STAGES"] == 2
    assert "flash_qtc" in src and "flash_q4tc" in src
    # no K/V reaches a CUDA-core body: the int4 one is gone too
    assert "flash_attend" not in src
    assert "to_f32(int8_t" not in src


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", QTC_CASES)
def test_qtc_numerics_match_pallas_and_ref(case, dtype):
    b, hq, hkv, hd, dv, s = case
    assert s <= INTERPRET_MAX_SEQ
    args = _inputs(*case, dtype=dtype)
    got = qtc_emulate(*args).numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, k_i8, k_s, v_i8, v_s = args
    pallas = np.asarray(flash_qprefill_attention(
        jnp.asarray(q.float().numpy(), jdt),
        *(jnp.asarray(t.numpy()) for t in (k_i8, k_s, v_i8, v_s)),
        interpret=True))
    ref = flash_qprefill_ref(*args).numpy()
    assert got.shape == pallas.shape == ref.shape == (b, s, hq, dv)
    assert np.isfinite(got).all()
    # the codes are exact, so are their products with bf16 q terms in f32;
    # p' is carried to ~2^-17 by two terms, f32 q likewise; the rest is f32
    # summation order and where the scales multiply
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bk", BKS)
def test_qtc_numerics_at_every_instantiated_bk(bk, dtype):
    """The loop at each BK the body instantiates: where the online softmax
    rescales moves with the tile, and the output stays within ATOL of the
    reference (S 200: four tiles at 64, the last ragged; seven at 32)."""
    args = _inputs(1, 8, 2, 128, 128, 200, dtype=dtype)
    got = qtc_emulate(*args, bk=bk).numpy()
    ref = flash_qprefill_ref(*args).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", QTC_CASES)
def test_one_bf16_term_of_p_misses_the_tolerance(case):
    """Why the value product splits p' = p * v_s: one bf16 rounding of it
    (relative 2^-9) moves the output by more than ATOL at the same inputs,
    the two-term split by a small fraction of it."""
    args = _inputs(*case)
    ref = flash_qprefill_ref(*args)
    one = float((qtc_emulate(*args, p_terms=1) - ref).abs().max())
    two = float((qtc_emulate(*args, p_terms=2) - ref).abs().max())
    assert one > ATOL
    assert two < ATOL / 5


@pytest.mark.parametrize("case", QTC_CASES)
def test_one_bf16_term_of_f32_q_misses_the_tolerance(case):
    """Why f32 q is split: its bf16 rounding alone moves the scores, and so
    the output, by more than ATOL; hi + lo lands well inside it."""
    args = _inputs(*case, dtype=torch.float32)
    ref = flash_qprefill_ref(*args)
    one = float((qtc_emulate(*args, q_terms=1) - ref).abs().max())
    two = float((qtc_emulate(*args, q_terms=2) - ref).abs().max())
    assert one > ATOL
    assert two < ATOL / 5


def test_cpu_call_counts_no_body():
    args = _inputs(1, 4, 2, 32, 32, 9)
    before = dict(flash_prefill.flash_qprefill.launches_by_body)
    flash_prefill.flash_qprefill(*args)
    flash_prefill.flash_qprefill(args[0].float(), *args[1:])
    assert flash_prefill.flash_qprefill.launches_by_body == before
    assert flash_prefill.QBODY == {torch.bfloat16: "qtc",
                                   torch.float32: "qtc_f32"}
