"""The tile plan and arithmetic of the bf16 MLA flash prefill body, on the
CPU.

``csrc/flash_prefill.cu``'s ``flash_mla`` (the wgmma + TMA body of the
192 / 128 width class) runs only on a card. Its plan is emulated here in
plain PyTorch, in its order of work: CTAs of BM group-flattened query rows
(``r = s * G + g``) in two warpgroups of 64, K / V tiles of BK keys up to
the CTA's last query position (tiles above the diagonal skipped), the mask
applied only on a tile that crosses a warpgroup's diagonal or passes S,
scores in log2 units (``qk * (log2(e) / sqrt(hd))``, then ``exp2``), the
running max seeded at RUN_INIT, the value product over p split into two
bf16 terms, and O times one reciprocal of l a row. The tile sizes are read from the CUDA source. The emulation
is held to ``flash_prefill_ref`` and to the JAX Pallas kernel in interpret
mode at MLA's hd 192 / dv 128; the card kernel itself is held to
``flash_prefill_ref`` in ``test_torch_cuda.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill import flash_prefill_attention  # noqa: E402
from repro_torch.kernels import flash_prefill  # noqa: E402
from repro_torch.kernels.ref import (NEG_INF, RUN_INIT,  # noqa: E402
                                     flash_prefill_ref)

SRC = (Path(flash_prefill.__file__).resolve().parents[1] / "csrc"
       / "flash_prefill.cu").read_text()
MLA_SRC = SRC[SRC.index("namespace mla {"):SRC.index("}  // namespace mla")]
ATOL = 1e-4      # the card kernel's tolerance against flash_prefill_ref


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", MLA_SRC).group(1))


BM, BK, CONSUMERS = _const("BM"), _const("BK"), _const("CONSUMERS")
LOG2E = np.float32(float(re.search(r"constexpr float LOG2E = ([\d.]+)f;",
                                   MLA_SRC).group(1)))


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def tile_plan(s, g):
    """[(row block, first row, rows, tiles)] in launch order (latest row
    block first): each CTA's K / V tiles run up to its last query
    position."""
    rows_total = s * g
    n_blocks = -(-rows_total // BM)
    plan = []
    for x in range(n_blocks):
        rb = n_blocks - 1 - x
        r0 = rb * BM
        last = min(r0 + BM, rows_total) - 1
        plan.append((rb, r0, min(BM, rows_total - r0), last // g // BK + 1))
    return plan


def mla_emulate(q, k, v, p_terms=2):
    """q [B,S,Hq,hd], k [B,S,Hkv,hd], v [B,S,Hkv,dv] bf16 -> [B,S,Hq,dv]
    f32, as ``flash_mla`` computes it."""
    b, s, hq, hd = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    g = hq // hkv
    qf = q.float().reshape(b, s, hkv, g, hd).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(b, hkv, s * g, hd)
    kf, vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    scale = torch.tensor(LOG2E / np.sqrt(np.float32(hd)))
    out = torch.empty((b, hkv, s * g, dv))
    for _, r0, n, n_tiles in tile_plan(s, g):
        for w in range(CONSUMERS):                 # 64 rows a warpgroup
            w0 = r0 + 64 * w
            if w0 >= r0 + n:
                continue
            rows = torch.arange(w0, w0 + 64)
            qpos = rows // g
            qw = torch.zeros((b, hkv, 64, hd))     # rows past S * G: zero
            live = rows < s * g
            qw[:, :, live] = qf[:, :, rows[live]]
            m = torch.full((b, hkv, 64, 1), RUN_INIT)
            den = torch.zeros((b, hkv, 64, 1))
            acc = torch.zeros((b, hkv, 64, dv))
            for t in range(n_tiles):
                k0 = t * BK
                kt = torch.zeros((b, hkv, BK, hd))  # keys past S: zero
                vt = torch.zeros((b, hkv, BK, dv))
                kt[:, :, :min(BK, s - k0)] = kf[:, :, k0:k0 + BK]
                vt[:, :, :min(BK, s - k0)] = vf[:, :, k0:k0 + BK]
                sc = (qw @ kt.transpose(-1, -2)) * scale
                if k0 + BK - 1 > w0 // g or k0 + BK > s:
                    kp = torch.arange(k0, k0 + BK)
                    off = (kp[None, :] > qpos[:, None]) | (kp[None, :] >= s)
                    sc = torch.where(off, torch.tensor(NEG_INF), sc)
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(sc - m_new)
                den = den * alpha + p.sum(-1, keepdim=True)
                hi = _bf16(p)
                acc = acc * alpha + hi @ vt
                if p_terms == 2:
                    acc = acc + _bf16(p - hi) @ vt
                m = m_new
            res = acc * torch.reciprocal(den)     # one reciprocal a row
            out[:, :, rows[live]] = res[:, :, live]
    out = out.reshape(b, hkv, s, g, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, hq, dv)


def _inputs(b, hq, hkv, hd, dv, s):
    rng = np.random.default_rng(b * 1000 + hq * 100 + hd + s)
    shapes = ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, dv))
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(
        torch.bfloat16) for sh in shapes]


# (b, hq, hkv, hd, dv, s): deepseek-v2's 192 / 128 at one kv head a query
# head, S not a multiple of the tiles (1 key; 130 crosses a tile; 300
# spans three tiles and three row blocks, above INTERPRET_MAX_SEQ, where
# interpret mode runs the JAX tiled oracle), a second batch and GQA
MLA_CASES = [(1, 2, 2, 192, 128, 1),
             (1, 2, 2, 192, 128, 130),
             (1, 2, 2, 192, 128, 300),
             (2, 2, 2, 192, 128, 77),
             (1, 6, 2, 136, 64, 50)]


@pytest.mark.parametrize("case", MLA_CASES)
def test_mla_plan_matches_pallas_and_ref(case):
    b, hq, hkv, hd, dv, s = case
    q, k, v = _inputs(*case)
    got = mla_emulate(q, k, v).numpy()
    pallas = np.asarray(flash_prefill_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        interpret=True))
    ref = flash_prefill_ref(q, k, v).numpy()
    assert got.shape == pallas.shape == ref.shape == (b, s, hq, dv)
    assert np.isfinite(got).all()
    # bf16 operands exact in f32, p carried to ~2^-17 by its two terms,
    # the log2-unit scores and exp2 within a few f32 roundings of the
    # reference's division and exp; the rest is f32 summation order
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_one_bf16_term_of_p_misses_the_tolerance():
    """Why the value product takes p in two bf16 terms in the MLA body as
    in the others: one term misses ATOL at deepseek-v2's widths."""
    q, k, v = _inputs(1, 2, 2, 192, 128, 130)
    ref = flash_prefill_ref(q, k, v)
    one = float((mla_emulate(q, k, v, p_terms=1) - ref).abs().max())
    two = float((mla_emulate(q, k, v, p_terms=2) - ref).abs().max())
    assert one > ATOL
    assert two < ATOL / 5


@pytest.mark.parametrize("s,g", [(1, 1), (128, 1), (129, 1), (1024, 1),
                                 (300, 3), (77, 8)])
def test_tile_plan_covers_the_causal_triangle_once(s, g):
    """Every row block runs the tiles up to its last query position and no
    further: each (row, visible key) pair is computed in exactly one CTA,
    and no CTA runs a tile whose first key lies past all its rows."""
    seen = np.zeros((s * g, s), dtype=np.int64)
    plan = tile_plan(s, g)
    assert [rb for rb, *_ in plan] == sorted((rb for rb, *_ in plan),
                                             reverse=True)
    for _, r0, n, n_tiles in plan:
        last_pos = (r0 + n - 1) // g
        assert (n_tiles - 1) * BK <= last_pos < n_tiles * BK
        for r in range(r0, r0 + n):
            pos = r // g
            keys = np.arange(min(n_tiles * BK, s))
            seen[r, keys[keys <= pos]] += 1
    want = (np.arange(s)[None, :] <= (np.arange(s * g) // g)[:, None])
    assert np.array_equal(seen, want.astype(np.int64))


def test_source_budgets_and_routes():
    """The body's shared memory (Q once, STAGES of K and V tiles) fits the
    card's 227 KB, its boxes are 64 bf16 columns (one 128-byte swizzle
    row), and the wrapper sends a bf16 192x128 prefill to it only where TMA
    can read the rows: hd and dv multiples of 8, 16-byte aligned tensors.
    The f32 class and the rows TMA cannot take keep ``flash_tc``."""
    stages, cols = _const("STAGES"), _const("COLS")
    assert (BM, BK, CONSUMERS, cols) == (128, 128, 2, 64)
    q_bytes = BM * 192 * 2
    smem = 1024 + q_bytes + stages * BK * (192 + 128) * 2 + 4 * stages * 8
    assert smem <= 227 * 1024
    assert "hd <= MAXD || hd % 8 || dv % 8 ||" in " ".join(SRC.split())
    body_for = flash_prefill.body_for
    q, k, v = _inputs(1, 2, 2, 192, 128, 4)
    assert body_for(q, k, v) == flash_prefill.MLA_BODY == "tc_mla"
    assert body_for(q.float(), k.float(), v.float()) == "tc_f32"
    q2, k2, v2 = _inputs(1, 2, 2, 150, 64, 4)
    assert body_for(q2, k2, v2) == "tc"            # hd 150: 300-byte rows
    q3, k3, v3 = _inputs(1, 2, 2, 64, 64, 4)
    assert body_for(q3, k3, v3) == "tc"            # not the MLA class
    store = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)
    shifted = store[1:].view(q.shape)              # 2 bytes into storage
    shifted.copy_(q)
    assert body_for(shifted, k, v) == "tc"
    assert set(flash_prefill.flash_prefill.launches_by_body) == set(
        flash_prefill.BODIES)
