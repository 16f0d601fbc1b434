"""The w8a8 GEMMs' card layout and plan, on the CPU.

``csrc/qmatmul.cu`` runs only on a card. What surrounds it is checked here:
the packed weight (K-major ``[N, Kp]``) and its plain versions against the
``[K, N]`` ones and the JAX Pallas kernels in interpret mode; ``place_params``,
which packs every int8 linear leaf when a tree moves to the card; the plan,
whose blocks must cover every output tile once; and numpy emulations of the
two bodies' operand layouts (the 128-byte swizzle that TMA writes and the
``wgmma`` descriptors read, and the decode body's K permutation inside a
chunk), with the layout constants read from the CUDA source so the two
cannot drift. The kernels themselves are held to the plain versions in
``test_torch_cuda.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import dynquant as j_dynquant  # noqa: E402
from repro.kernels import qmatmul as j_qmatmul  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.api.variants import VariantSpec  # noqa: E402
from repro_torch.data import VQITask, vqi_batch  # noqa: E402
from repro_torch.kernels import dynquant, ops, qmatmul  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models.layers import place_params  # noqa: E402
from repro_torch.serving import InferenceSession  # noqa: E402
from repro_torch.tree import map_with_path  # noqa: E402

CU = Path(qmatmul.__file__).resolve().parents[1] / "csrc" / "qmatmul.cu"


def _cu_constants():
    """Every namespace-level ``constexpr int NAME = expr;`` of the source,
    evaluated in order."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 CU.read_text(), flags=re.M):
        env[name] = int(eval(expr, {}, dict(env)))
    return env


C = _cu_constants()

# the port's kernel tests' ragged shapes: no dimension a multiple of the
# TPU blocks or the card's tiles
GEMM_SHAPES = [(7, 48, 33), (130, 257, 129), (1, 128, 256)]
# (K, N): stablelm-1.6b, phi-3-vision and deepseek-7b's weight shapes
# (chip_smoke.py's GEMM_KN, VQI_GEMM_KN and DENSE_GEMM_CASES) and the card
# tests' ragged ones
PLAN_KN = [(2048, 2048), (2048, 11264), (5632, 2048), (2048, 100352),
           (3072, 3072), (3072, 16384), (8192, 3072), (1024, 3072),
           (3072, 32064), (4096, 4096), (4096, 22016), (11008, 4096),
           (4096, 102400), (300, 203), (257, 129), (640, 1024)]
PLAN_M = list(range(1, 18)) + [64, 128, 255, 1023, 1024, 4632]


def test_python_mirrors_the_source_constants():
    assert qmatmul.PACK_K == C["PACK_K"] == C["SW_ROW_BYTES"]
    assert qmatmul.GEMV_MAX_M == C["GEMV_MAX_M"]
    assert qmatmul.GEMV_PAD == C["GEMV_PAD"]
    assert qmatmul.GROUP_M == C["GROUP_M"]
    src = CU.read_text()
    for bm, bn in qmatmul.TILES:                 # every tile is instantiated
        assert f"bm == {bm} && bn == {bn}" in src


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (m, k)).astype(np.float32)
    x[::2, 0] = 127.0                     # dynamic inv = 1 on even rows:
    x[::2, 1:] = rng.integers(-126, 126, (len(x[::2]), k - 1)) + 0.5
    xj = jnp.asarray(x, jnp.bfloat16)     # .5 quotients, round half to even
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    w = jax.random.normal(jax.random.PRNGKey(seed), (k, n), jnp.float32)
    w_i8, w_s = j_ref.quantize_ref(w)
    return (xj, xt, w_i8, w_s, torch.from_numpy(np.array(w_i8)),
            torch.from_numpy(np.array(w_s)))


@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_packed_plain_version_matches_kn_and_pallas(shape, mode):
    m, k, n = shape
    xj, xt, w_i8, w_s, tw, ts = _case(m, k, n, seed=m + k + n)
    wp = qmatmul.pack_weight(tw)
    assert wp.shape == (n, qmatmul.packed_k(k)) and wp.is_contiguous()
    assert torch.equal(wp[:, :k], tw.t()) and not wp[:, k:].any()
    if mode == "dynamic":
        got = dynquant.qmatmul_dynamic_packed(xt, wp, ts)
        kn = dynquant.qmatmul_dynamic(xt, tw, ts)
        want = np.asarray(j_dynquant.qmatmul_dynamic(xj, w_i8, w_s,
                                                     interpret=True))
        bf16 = dynquant.qmatmul_dynamic_packed(xt, wp, ts,
                                               out_dtype=torch.bfloat16)
    else:
        act = float(np.abs(np.asarray(xj, np.float32)).max() / 127.0)
        got = qmatmul.qmatmul_static_packed(xt, wp, ts, torch.tensor(act))
        kn = qmatmul.qmatmul_static(xt, tw, ts, torch.tensor(act))
        want = np.asarray(j_qmatmul.qmatmul_static(
            xj, w_i8, w_s, jnp.float32(act), interpret=True))
        bf16 = qmatmul.qmatmul_static_packed(xt, wp, ts, torch.tensor(act),
                                             out_dtype=torch.bfloat16)
    # the same integer sums in the same epilogue order: bit for bit against
    # the [K, N] plain version, rtol 1e-6 (one f32 rounding of the scale
    # products) against the Pallas kernel, as test_torch_kernels.py holds it
    assert torch.equal(got, kn)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert bf16.dtype == torch.bfloat16 and torch.equal(
        bf16, got.to(torch.bfloat16))


def test_packed_entry_points_check_their_operands():
    x = torch.zeros((3, 200))
    w = torch.zeros((200, 24), dtype=torch.int8)
    s = torch.ones((1, 24))
    with pytest.raises(ValueError, match="w_packed"):
        dynquant.qmatmul_dynamic_packed(x, w, s)       # the [K, N] layout
    with pytest.raises(TypeError, match="out_dtype"):
        dynquant.qmatmul_dynamic(x, w, s, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="int8"):
        qmatmul.pack_weight(w.float())


def _vlm(variant):
    cfg = configs.smoke_config("phi-3-vision-4.2b").with_overrides(
        dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batches = [vqi_batch(gen, cfg, VQITask(), 2, device="cpu")
               for _ in range(2)]
    spec = {"dynamic_int8": VariantSpec.dynamic_int8(),
            "static_int8": VariantSpec.static_int8(calib_batches=2)}[variant]
    qparams, _ = spec.build(params, cfg, calib_data=batches)
    return cfg, qparams, {k: batches[0][k]
                          for k in ("tokens", "frontend_embeds")}


def _paths(tree):
    out = {}
    map_with_path(lambda p, t: out.__setitem__(p, t), tree)
    return out


@pytest.mark.parametrize("variant", ["dynamic_int8", "static_int8"])
def test_place_params_packs_every_int8_linear(variant):
    cfg, qparams, batch = _vlm(variant)
    before = _paths(qparams)
    linears = {p[:-len("/w_int8")] for p in before
               if p.endswith("/w_int8") and not p.startswith("embed/")}
    assert "unembed" in linears and "frontend_proj" in linears
    assert "embed/w_int8" in before          # the embedding is int8 too
    packed = place_params(qparams, "cpu", pack=True)
    after = _paths(packed)
    assert {p[:-len("/w_packed")] for p in after
            if p.endswith("/w_packed")} == linears
    assert not any(p.endswith("/w_int8") for p in after
                   if not p.startswith("embed/"))
    assert torch.equal(after["embed/w_int8"], before["embed/w_int8"])
    for leaf in linears:
        assert torch.equal(after[f"{leaf}/w_packed"],
                           qmatmul.pack_weight(before[f"{leaf}/w_int8"]))
        for key in ("scale", "act_scale"):
            if f"{leaf}/{key}" in before:
                assert torch.equal(after[f"{leaf}/{key}"],
                                   before[f"{leaf}/{key}"])
    again = _paths(place_params(packed, "cpu", pack=True))     # idempotent
    assert again.keys() == after.keys() and all(
        torch.equal(again[p], after[p]) for p in after
        if isinstance(after[p], torch.Tensor))
    # the packed tree computes the same logits, bit for bit
    want = forward(qparams, batch, cfg)[0]
    assert torch.equal(forward(packed, batch, cfg)[0], want)


def test_place_params_leaves_expert_leaves_unpacked():
    """An MoE artifact's 3-D expert codes (``moe/wi [E, d, 2ff]``, ``moe/wo
    [E, ff, d]``) stay as they are: ``moe_ffn`` dequantizes them, no GEMM
    reads them. Its 2-D linears (MLA's projections, the shared experts,
    the dense head layer's FFN) are packed."""
    from repro_torch import configs as t_configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import init_params

    cfg = t_configs.smoke_config("deepseek-v2-236b").with_overrides(
        dtype="float32")
    qparams, _ = VariantSpec.dynamic_int8().build(
        init_params(cfg, seed=0, device="cpu"), cfg)
    tree = place_params(qparams, "cpu", pack=True)
    packed, before = _paths(tree), _paths(qparams)
    experts = [p for p in before if "/moe/w" in p and p.endswith("/w_int8")]
    assert experts and all(before[p].dim() == 3 for p in experts)
    for p in experts:
        assert torch.equal(packed[p], before[p])
    for leaf in ("layers/0/moe/shared_wi", "layers/0/attn/w_ukv",
                 "head_layers/0/mlp/wi", "head_layers/0/attn/w_dq"):
        assert f"{leaf}/w_packed" in packed and f"{leaf}/w_int8" not in packed
    assert "layers/0/moe/router" in packed           # fp, never quantized
    assert tree["layers"][0]["moe"]["wi"].keys() == {"w_int8", "scale"}
    toks = {"tokens": torch.arange(12).reshape(1, 12)}
    torch.testing.assert_close(forward(tree, toks, cfg)[0],
                               forward(qparams, toks, cfg)[0], atol=1e-5,
                               rtol=0)


def test_cpu_session_keeps_the_jax_layout():
    cfg, qparams, batch = _vlm("dynamic_int8")
    session = InferenceSession(qparams, cfg, device="cpu")
    before, after = _paths(qparams), _paths(session.params)
    assert before.keys() == after.keys()
    assert all(torch.equal(before[p], after[p]) for p in before
               if isinstance(before[p], torch.Tensor))
    assert torch.equal(session.logits(batch), forward(qparams, batch, cfg)[0])


@pytest.mark.parametrize("k,n", PLAN_KN)
def test_plan_covers_every_output_tile_once(k, n):
    for m in PLAN_M:
        p = qmatmul.plan(m, n, k)
        assert p.body == ("gemv" if m <= qmatmul.GEMV_MAX_M else "wgmma")
        tiles = list(qmatmul.block_tiles(p, m, n))
        assert len(tiles) == p.blocks
        # tiles on the (bm, bn) grid, none twice, none empty or outside,
        # as many as the grid has cells: an exact cover of [0, M) x [0, N)
        assert len({(r0, c0) for r0, _, c0, _ in tiles}) == len(tiles)
        assert all(r0 % p.bm == 0 and c0 % p.bn == 0 and r0 < r1 <= m
                   and c0 < c1 <= n for r0, r1, c0, c1 in tiles)
        assert len(tiles) == -(-m // p.bm) * -(-n // p.bn)
        assert sum((r1 - r0) * (c1 - c0)
                   for r0, r1, c0, c1 in tiles) == m * n
        if p.body == "gemv":
            assert p.bn == 8 * p.ng and p.ng in (1, 2, 4, 8)
            assert qmatmul.gemv_smem(m, qmatmul.packed_k(k)) <= 227 * 1024
        else:
            assert (p.bm, p.bn) in qmatmul.TILES
            # mid M still puts most of a wave of blocks on the 132 SMs
            if 37 <= m <= 1024 and n >= 2048:
                assert p.blocks >= 99


def test_plan_raster_keeps_a_wave_within_group_m_tile_rows():
    p = qmatmul.plan(4632, 16384, 3072)
    assert (p.bm, p.bn) == (128, 256)
    wave = list(qmatmul.block_tiles(p, 4632, 16384))[:132]
    assert len({r0 for r0, _, _, _ in wave}) <= qmatmul.GROUP_M


# ------------------------------------------------------------------ #
# Operand layouts, emulated in numpy
# ------------------------------------------------------------------ #
def _tma_sw128(tile):
    """A [rows, 128] byte box as TMA writes it with 128-byte swizzle into a
    1024-byte-aligned buffer: 16-byte chunk c of row r lands at chunk
    c ^ (r % 8)."""
    rows, width = tile.shape
    assert width == C["SW_ROW_BYTES"]
    smem = np.zeros(rows * width, np.int8)
    for r in range(rows):
        for c in range(width // 16):
            dst = r * width + (c ^ (r % C["SW_ATOM_ROWS"])) * 16
            smem[dst:dst + 16] = tile[r, c * 16:(c + 1) * 16]
    return smem


def _desc(addr):
    """``sw128_desc``: start address / 16, LBO 1, SBO / 16, layout 1."""
    return ((addr & 0x3FFFF) >> 4) | (1 << 16) \
        | ((C["SW_SBO_BYTES"] >> 4) << 32) | (1 << 62)


def _wgmma_read(smem, desc, rows, base=0, swizzle=True):
    """The [rows, WG_K_BYTES] K-major operand a descriptor selects: row r,
    byte j at start + (r // 8) * SBO + (r % 8) * 128 + j, with the 128-byte
    swizzle applied to that address (bits 4-6 ^= bits 7-9)."""
    assert desc >> 62 == 1                        # 128-byte swizzle
    start = ((desc & 0x3FFF) << 4) - base
    sbo = ((desc >> 32) & 0x3FFF) << 4
    out = np.zeros((rows, C["WG_K_BYTES"]), np.int64)
    for r in range(rows):
        for j in range(C["WG_K_BYTES"]):
            a = start + (r // C["SW_ATOM_ROWS"]) * sbo \
                + (r % C["SW_ATOM_ROWS"]) * C["SW_ROW_BYTES"] + j
            if swizzle:
                a ^= ((a >> 7) & 7) << 4
            out[r, j] = smem[a]
    return out


def _wgmma_tile(a_tile, b_tile, base=0x4000, **kw):
    """One K tile of the consumer loop: PACK_K / WG_K_BYTES k32 steps, each
    advancing both descriptors' start address by WG_K_BYTES."""
    sa, sb = _tma_sw128(a_tile), _tma_sw128(b_tile)
    acc = np.zeros((a_tile.shape[0], b_tile.shape[0]), np.int64)
    for kk in range(C["PACK_K"] // C["WG_K_BYTES"]):
        off = kk * C["WG_K_BYTES"]
        a = _wgmma_read(sa, _desc(base + off), a_tile.shape[0], base, **kw)
        b = _wgmma_read(sb, _desc(base + off), b_tile.shape[0], base, **kw)
        acc += a @ b.T
    return acc


@pytest.mark.parametrize("bn", [16, 64, 256])
def test_sw128_layout_and_descriptor_steps_give_the_tile_product(bn):
    rng = np.random.default_rng(bn)
    a = rng.integers(-127, 128, (64, C["PACK_K"])).astype(np.int8)
    b = rng.integers(-127, 128, (bn, C["PACK_K"])).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    np.testing.assert_array_equal(_wgmma_tile(a, b), want)
    # the emulation sees a missing swizzle
    assert not np.array_equal(_wgmma_tile(a, b, swizzle=False), want)


def test_gemv_chunk_permutation_gives_the_product():
    """The decode body's 16 x 8 warp tile over K: lane (g, t) loads bytes
    [32 t, 32 t + 32) of weight row g of each 128-byte chunk, step s feeds
    bytes [8 s, 8 s + 8) as b0 | b1, and the A fragment the same 8 bytes of
    code rows g and g + 8, placed as mma.sync m16n8k32 places them."""
    rng = np.random.default_rng(5)
    k = 3 * C["PACK_K"]
    a = rng.integers(-127, 128, (16, k)).astype(np.int64)
    w = rng.integers(-127, 128, (8, k)).astype(np.int64)
    d = np.zeros((16, 8), np.int64)
    for c in range(k // C["PACK_K"]):
        for s in range(4):
            # mma position p of K (0..31) -> the k it holds, per lane
            frag_a = np.zeros((16, 32), np.int64)
            frag_b = np.zeros((32, 8), np.int64)
            for g in range(8):
                for t in range(4):
                    base = c * C["PACK_K"] + 32 * t + 8 * s
                    for i in range(4):
                        for p, kk in ((4 * t + i, base + i),
                                      (16 + 4 * t + i, base + 4 + i)):
                            frag_a[g, p] = a[g, kk]
                            frag_a[g + 8, p] = a[g + 8, kk]
                            frag_b[p, g] = w[g, kk]
            d += frag_a @ frag_b
    np.testing.assert_array_equal(d, a @ w.T)


def test_gemv_fragment_loads_are_conflict_free():
    """The 8-byte code loads of a half-warp (lanes g 0..3 or 4..7, t 0..3)
    at g * (Kp + GEMV_PAD) + 32 t + 8 s fall in 16 distinct 8-byte bank
    pairs of the 128-byte bank row."""
    for kp in (128, 2048, 5632, 8192):
        lda = kp + C["GEMV_PAD"]
        for s in range(4):
            for half in (range(4), range(4, 8)):
                slots = {(g * lda + 32 * t + 8 * s) % 128 // 8
                         for g in half for t in range(4)}
                assert len(slots) == 16


def test_ops_packed_dispatch_flattens_scales():
    m, k, n = 5, 200, 24
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    s = torch.full((1, 1), 0.01)                   # per-tensor scale
    wp = qmatmul.pack_weight(w)
    assert torch.equal(ops.qmatmul_packed(x, wp, s),
                       ops.qmatmul_dynamic(x, w, s))
    assert torch.equal(ops.qmatmul_packed(x, wp, s, torch.tensor(0.02)),
                       ops.qmatmul_static(x, w, s, torch.tensor(0.02)))
    assert torch.equal(t_ref.qmatmul_dynamic_packed_ref(x, wp, s.expand(1, n)),
                       t_ref.qmatmul_dynamic_ref(x, w, s.expand(1, n)))
