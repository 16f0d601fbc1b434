"""The quantized-KV decode kernels' split plan, on the CPU.

``csrc/decode_split.cuh`` runs only on a card (thread-block clusters,
distributed shared memory). Its plan is emulated here in torch, in its
order of work: the host's choice of splits, each CTA's share of whole
tiles, each warp's steps of 32 / LPR slot rows with its own online softmax
(running max seeded at RUN_INIT, masked slots at NEG_INF and never read,
rescaled when the warp's max moves), the warps' merge and the cluster's
merge in rank order. It reads three code formats: bf16 or f32 elements
with no scale (``paged_decode``), int8 codes with a per-row scale after the
dot (``qdecode``, ``paged_qdecode``) and nibble-packed int4 codes with f16
group scales, dequantized before the dot (``paged_q4decode``). The
constants, the codes a lane holds and the lane plan are read from the CUDA
source, so the model and the kernel cannot drift. The model is held to the
plain versions (``paged_decode_ref``, ``qdecode_ref``,
``paged_qdecode_ref``, ``paged_q4decode_ref``) and to the JAX Pallas
kernels in interpret mode; the kernels themselves are held to the plain
versions in ``test_torch_cuda.py``.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attn import (paged_decode_attention,  # noqa: E402
                                      paged_q4decode_attention,
                                      paged_qdecode_attention)
from repro.kernels.qdecode import qdecode_attention  # noqa: E402
from repro_torch.kernels import paged_attn, qdecode  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels.quantize import (KV_GROUP,  # noqa: E402
                                          dequantize_kv_int4)

CUH = Path(qdecode.__file__).resolve().parents[1] / "csrc" / "decode_split.cuh"
NEG_INF_BIAS = -2.0e38


def _cuh_constants():
    """Every namespace-level ``constexpr int|float NAME = expr;`` of the
    header, evaluated in order."""
    env = {}
    for kind, name, expr in re.findall(
            r"^constexpr (int|float) (\w+) = ([^;]+);", CUH.read_text(),
            flags=re.M):
        if kind == "int":
            env[name] = int(eval(expr, {}, dict(env)))
        else:
            env[name] = float(expr.rstrip("f"))
    return env


C = _cuh_constants()
KT, NW, PT = C["KT"], C["NW"], C["PT"]
# test name: header struct (fp: Fp<T>, bf16 or f32 pools)
FORMATS = {"int8": "Int8", "int4": "Int4", "fp": "Fp"}


def _c_eval(expr, env):
    """A C expression of ternaries over comparisons, evaluated."""
    expr = expr.strip()
    while expr.startswith("(") and expr.endswith(")"):
        depth = 0
        for i, ch in enumerate(expr):
            depth += {"(": 1, ")": -1}.get(ch, 0)
            if depth == 0 and i < len(expr) - 1:
                break
        else:
            expr = expr[1:-1].strip()
            continue
        break
    depth, q_at, colon_at, pending = 0, None, None, 0
    for i, ch in enumerate(expr):
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if depth:
            continue
        if ch == "?":
            if q_at is None:
                q_at = i
            else:
                pending += 1
        elif ch == ":" and q_at is not None:
            if pending:
                pending -= 1
            else:
                colon_at = i
                break
    if q_at is None:
        return eval(expr, {}, dict(env))
    cond = _c_eval(expr[:q_at], env)
    return _c_eval(expr[q_at + 1:colon_at] if cond else expr[colon_at + 1:],
                   env)


def _lane_codes_source(fmt):
    """The body of ``FORMATS[fmt]::lane_codes`` in the header."""
    body = re.search(rf"struct {FORMATS[fmt]} {{(.*?)\n}};", CUH.read_text(),
                     flags=re.S).group(1)
    return re.search(r"lane_codes\(int(?: gb)?\) {\s*return ([^;]+);",
                     body).group(1)


# ------------------------------------------------------------------ #
# The host's plan, mirrored from the header
# ------------------------------------------------------------------ #
def lane_codes(gb, fmt="int8"):
    """Codes a lane holds of one K or V row, read from the header."""
    return _c_eval(_lane_codes_source(fmt), {"gb": gb})


def group_bound(g):
    return 1 if g == 1 else (4 if g <= 4 else 8)


def lanes_per_row(hd, gb, fmt="int8"):
    v = -(-hd // lane_codes(gb, fmt))           # ceil
    return 2 if v <= 2 else (4 if v <= 4 else (8 if v <= 8 else 16))


def splits_for(n_keys_max, pairs, resident):
    s = 1
    while (s < C["MAX_SPLITS"] and s * KT < n_keys_max
           and pairs * 2 * s <= resident):
        s *= 2
    return s


def share(n_keys, splits, rank):
    n = max(n_keys, 0)
    per = -(-(-(-n // KT)) // splits)        # ceil(ceil(n / KT) / splits)
    k0 = min(rank * per * KT, n)
    return k0, min(k0 + per * KT, n)


def test_python_mirrors_the_source():
    src = CUH.read_text()
    for line in ("return G == 1 ? 1 : (G <= 4 ? 4 : 8);",
                 "const int lc = Fmt::lane_codes(gb), v = (hd + lc - 1) / lc;",
                 "return v <= 2 ? 2 : (v <= 4 ? 4 : (v <= 8 ? 8 : 16));",
                 "while (s < MAX_SPLITS && s * KT < n_keys_max && "
                 "pairs * 2 * s <= resident)",
                 "const int per = (tiles + splits - 1) / splits;",
                 "k0 = min(rank * per * KT, n);",
                 "k1 = min(k0 + per * KT, n);"):
        assert line in " ".join(src.split()), line
    assert (PT, NW, KT) == (128, 4, 32)
    assert C["MAX_SPLITS"] == 8                   # the portable cluster size
    assert C["NEG_INF"] == NEG_INF_BIAS == t_ref.NEG_INF
    assert C["RUN_INIT"] == t_ref.RUN_INIT
    assert qdecode.MAX_GROUP == paged_attn.MAX_GROUP == C["MAXG"]
    assert qdecode.MAX_HEAD_DIM == paged_attn.MAX_HEAD_DIM == C["MAXD"]
    assert paged_attn.KEY_TILE == KT
    assert [lane_codes(gb) for gb in (1, 4, 8)] == [16, 16, 8]
    assert [lane_codes(gb, "int4") for gb in (1, 4, 8)] == [32, 16, 8]
    assert [lane_codes(gb, "fp") for gb in (1, 4, 8)] == [8, 8, 8]
    # every (lanes, G bound) pair the shapes need is dispatched, and fits
    # the compiled bound (run<> refuses a pair that does not)
    assert "if constexpr (LPR * Fmt::lane_codes(GB) <= MAXD)" in src
    for fmt, step in (("int8", 16), ("int4", KV_GROUP), ("fp", 8)):
        for gb in (1, 4, 8):
            for hd in range(step, C["MAXD"] + 1, step):
                lpr = lanes_per_row(hd, gb, fmt)
                assert f"run<Fmt, {lpr}, {gb}>(go)" in src
                assert hd <= lpr * lane_codes(gb, fmt) <= C["MAXD"]


@pytest.mark.parametrize("gb", [1, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
def test_int4_lane_codes_lie_in_one_group(hd, gb):
    """An int4 lane loads a whole vector of packed codes (16, 8 or 4
    bytes) and needs one f16 scale each for K and V: its codes never cross
    a group of 32. acc[G][codes] stays within the int8 loop's registers."""
    vl = lane_codes(gb, "int4")
    lpr = lanes_per_row(hd, gb, "int4")
    assert vl // 2 in (16, 8, 4)                # one load of whole bytes
    assert gb * vl <= 64                         # acc[G][codes] as int8's
    assert lpr * vl >= hd
    lanes = [lane for lane in range(lpr) if lane * vl < hd]
    assert len(lanes) == -(-hd // vl)            # the rest are masked
    for lane in lanes:
        first, last = lane * vl, (lane + 1) * vl - 1
        assert first // KV_GROUP == last // KV_GROUP
        assert last < hd                         # no lane straddles hd


@pytest.mark.parametrize("gb", [1, 4, 8])
@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_fp_lanes_never_straddle_a_row(hd, gb):
    """An fp lane holds 8 elements (one 16-byte load of bf16, two of f32):
    every hd the wrapper takes (a multiple of 8 up to 128) is whole lanes,
    at most 16 of them, and lanes past hd are masked, never read across
    into the next head's row. acc[G][8] stays within 64 registers."""
    vl = lane_codes(gb, "fp")
    lpr = lanes_per_row(hd, gb, "fp")
    assert vl == 8 and hd % vl == 0
    assert gb * vl <= 64
    assert lpr in (2, 4, 8, 16) and hd <= lpr * vl <= C["MAXD"]
    lanes = [lane for lane in range(lpr) if lane * vl < hd]
    assert len(lanes) == hd // vl
    assert all((lane + 1) * vl <= hd for lane in lanes)
    assert lpr // 2 * vl < hd or lpr == 2        # no smaller row would do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fp_unpack_is_exact(dtype):
    """bf16 element 2i is the low half of word i and 2i + 1 the high half;
    each becomes f32 by a shift (w << 16, w & 0xffff0000), exact; an f32
    word is its element. Emulated on random words, held to torch's own
    conversion."""
    src = " ".join(CUH.read_text().split())
    assert "f[0] = __uint_as_float(w << 16);" in src
    assert "f[1] = __uint_as_float(w & 0xffff0000u);" in src
    assert "f[0] = __uint_as_float(w);" in src
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32) * 1e3)
    x = x.to(dtype)
    if dtype == torch.bfloat16:
        words = x.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
        words = words[0::2] | (words[1::2] << 16)          # little endian
        f = np.empty(x.numel(), np.float32)
        f[0::2] = (words << np.uint32(16)).view(np.float32)
        f[1::2] = (words & np.uint32(0xFFFF0000)).view(np.float32)
    else:
        f = x.numpy().view(np.uint32).view(np.float32)
    assert np.array_equal(f, x.float().numpy())


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_code_unpack_is_exact(fmt):
    """The kernel's unpack: a code's byte (int8: c + 128) or nibble (int4:
    c + 8) is placed under the exponent of 2^23 by a byte permute, and 2^23
    plus the bias is taken off; f32 holds every step exactly. Emulated on
    every code, with the source's constants."""
    src = " ".join(CUH.read_text().split())
    flip, bias = {"int8": (0x80808080, 8388736.0),
                  "int4": (0x88888888, 8388616.0)}[fmt]
    assert f"0x{flip:08x}u" in src and f"{int(bias)}.f" in src
    if fmt == "int8":
        codes = np.arange(-128, 128)
        words = (codes & 0xFF).astype(np.uint32)
        fields = [(words ^ flip) & 0xFF]
    else:
        codes = np.arange(-8, 8)
        words = (codes & 0xF).astype(np.uint32) * 0x11    # both nibbles
        x = words ^ flip
        fields = [x & 0x0F, (x >> 4) & 0x0F]              # lo, hi
    for field in fields:
        f = (np.uint32(0x4B000000) | field.astype(np.uint32)).view(
            np.float32) - np.float32(bias)
        assert np.array_equal(f, codes.astype(np.float32))


@pytest.mark.parametrize("n_keys_max,pairs,resident,want", [
    (1, 32, 792, 1), (32, 32, 792, 1), (33, 32, 792, 2), (100, 32, 792, 4),
    (512, 32, 792, 8), (5000, 1, 792, 8),
    # the engine's shapes: B8 x Hkv32 at G 1 (6 CTAs a SM), B8 x Hkv8 at
    # G 4 (3 a SM): all clusters resident at once
    (512, 256, 792, 2), (512, 64, 396, 4), (512, 8 * 32, 396, 1),
    (512, 4096, 792, 1)])
def test_splits_for(n_keys_max, pairs, resident, want):
    s = splits_for(n_keys_max, pairs, resident)
    assert s == want
    assert s & (s - 1) == 0 and 1 <= s <= C["MAX_SPLITS"]
    assert s == 1 or pairs * s <= resident


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("n_keys", [0, 1, 31, 32, 33, 63, 64, 65, 255, 256,
                                    257, 511, 512, 513, 4999])
def test_shares_cover_every_key_once_in_whole_tiles(n_keys, splits):
    seen = []
    for rank in range(splits):
        k0, k1 = share(n_keys, splits, rank)
        assert k0 % KT == 0 or k0 == n_keys
        assert k0 <= k1 and (k1 == n_keys or (k1 - k0) % KT == 0)
        seen += range(k0, k1)
    assert seen == list(range(n_keys))           # in rank order, once each


# ------------------------------------------------------------------ #
# The kernel's plan, emulated
# ------------------------------------------------------------------ #
def _attend_one(q, kf, ks, vf, vs, valid, add, n_keys, splits, lpr, chunk,
                bias_rows=False):
    """One sequence, all kv heads: q [Hkv,G,hd]; kf / vf [n, Hkv, hd] f32
    codes and ks / vs [n, Hkv] of the slots (zero where masked: a masked
    slot is never read); valid / add [n] -> out [Hkv,G,hd]. ``bias_rows``:
    the dense kernel's rows (running max seeded at RUN_INIT_BIAS, a lane
    row past the share scoring -inf)."""
    hkv, g, hd = q.shape
    r = 32 // lpr
    scale = torch.sqrt(torch.tensor(float(hd)))
    parts = []
    for rank in range(splits):
        k0, k1 = share(n_keys, splits, rank)
        m = torch.full((NW, hkv, g),
                       C["RUN_INIT_BIAS" if bias_rows else "RUN_INIT"])
        lsum = torch.zeros((NW, hkv, g, r))
        acc = torch.zeros((NW, hkv, g, r, hd))
        for c0 in range(k0, k1, chunk):
            c1 = min(c0 + chunk, k1)
            for st in range(-(-(c1 - c0) // r)):
                w = st % NW                          # step st -> warp st % 4
                ks_ = torch.arange(c0 + st * r, c0 + st * r + r)
                on = (ks_ < c1) & valid[ks_.clamp(max=len(valid) - 1)]
                kk = ks_.clamp(max=len(valid) - 1)
                dot = torch.einsum("hgd,rhd->hgr", q, kf[kk])
                sc = torch.where(on[None, None],
                                 dot * ks[kk].T[:, None] / scale
                                 + add[kk][None, None],
                                 torch.tensor(-math.inf if bias_rows
                                              else C["NEG_INF"]))
                mx = sc.amax(-1)
                moved = mx > m[w]
                alpha = torch.exp(m[w] - torch.where(moved, mx, m[w]))
                lsum[w] = lsum[w] * alpha[..., None]
                acc[w] = acc[w] * alpha[..., None, None]
                m[w] = torch.where(moved, mx, m[w])
                p = torch.exp(sc - m[w][..., None])
                lsum[w] = lsum[w] + p
                pv = p * torch.where(on, vs[kk].T, torch.tensor(0.0))[:, None]
                acc[w] = acc[w] + (pv[..., None]
                                   * vf[kk].permute(1, 0, 2)[:, None])
        lw, aw = lsum.sum(-1), acc.sum(-2)           # the row groups' sum
        mc = m.amax(0)                               # the warps' merge
        f = torch.exp(m - mc)
        parts.append((mc, (lw * f).sum(0), (aw * f[..., None]).sum(0)))
    mx = parts[0][0]
    for mr, _, _ in parts[1:]:                       # the cluster's merge
        mx = torch.maximum(mx, mr)
    ls = torch.zeros((hkv, g))
    a = torch.zeros((hkv, g, hd))
    for mr, lr, ar in parts:
        f = torch.exp(mr - mx)
        ls = ls + lr * f
        a = a + ar * f[..., None]
    return a / ls[..., None]


def _plan(q, n_keys_max, splits, fmt="int8"):
    g, hd = q.shape[2], q.shape[3]
    return (lanes_per_row(hd, group_bound(g), fmt),
            splits if splits else splits_for(n_keys_max, 1, 10 ** 9))


def model_qdecode(q, k_i8, k_s, v_i8, v_s, bias, splits=None):
    """The dense kernel's plan: every slot of S read, the bias added."""
    b, s = k_i8.shape[:2]
    lpr, splits = _plan(q, s, splits)
    valid = torch.ones(s, dtype=torch.bool)
    return torch.stack([
        _attend_one(q[i].float(), k_i8[i].float(), k_s[i], v_i8[i].float(),
                    v_s[i], valid, bias[i], s, splits, lpr, s,
                    bias_rows=True)
        for i in range(b)])


def model_paged(q, k_pool, k_scale, v_pool, v_scale, tables, pos,
                splits=None, fmt="int8"):
    """The paged kernel's plan: slot k < min(pos + 1, M * bs) of a mapped
    table entry is read; nothing else is. int4 rows are dequantized as they
    are read (code * s_g, exact) and fp rows become f32 (exact); both score
    with no scale after the dot: a unit row scale in the int8 model. fp
    pools have no scale pools (``k_scale`` / ``v_scale`` None)."""
    n, bs, hkv = k_pool.shape[:3]
    hd = q.shape[-1]
    b, m = tables.shape
    lpr, splits = _plan(q, m * bs, splits, fmt)
    outs = []
    for i in range(b):
        n_keys = min(int(pos[i]) + 1, m * bs)
        slots = torch.arange(max(n_keys, 1))
        ent = tables[i, slots // bs].long()
        valid = (ent >= 0) & (slots < n_keys)
        rows = torch.where(valid, ent * bs + slots % bs, 0)
        kf = torch.zeros((len(slots), hkv, hd))
        vf, ks, vs = torch.zeros_like(kf), torch.zeros((len(slots), hkv)), \
            torch.zeros((len(slots), hkv))
        live = rows[valid]                           # read only valid rows
        if fmt == "fp":
            kf[valid] = k_pool.reshape(n * bs, hkv, hd)[live].float()
            vf[valid] = v_pool.reshape(n * bs, hkv, hd)[live].float()
            ks[valid], vs[valid] = 1.0, 1.0
        elif fmt == "int8":
            kf[valid] = k_pool.reshape(n * bs, hkv, hd)[live].float()
            vf[valid] = v_pool.reshape(n * bs, hkv, hd)[live].float()
            ks[valid] = k_scale.reshape(n * bs, hkv)[live]
            vs[valid] = v_scale.reshape(n * bs, hkv)[live]
        else:
            for f, pool, sc in ((kf, k_pool, k_scale), (vf, v_pool, v_scale)):
                f[valid] = dequantize_kv_int4(
                    pool.reshape(n * bs, hkv, hd // 2)[live],
                    sc.reshape(n * bs, hkv, hd // KV_GROUP)[live])
            ks[valid], vs[valid] = 1.0, 1.0
        outs.append(_attend_one(q[i].float(), kf, ks, vf, vs, valid,
                                torch.zeros(len(slots)), n_keys, splits, lpr,
                                C["TAB_CAP"] * bs))
    return torch.stack(outs)


# ------------------------------------------------------------------ #
# Inputs made with numpy from a seed
# ------------------------------------------------------------------ #
def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _scales(rng, shape):
    # dequantized values of order 1, as quantized K/V are
    return (rng.uniform(0.5, 1.5, shape) / 127).astype(np.float32)


def _dense_case(seed, b, s, hkv, g, hd, pos):
    """``pos[i]``: the last unmasked slot of row i (-1: every slot masked,
    which the dense kernel averages uniformly, as the plain softmax does)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    bias = np.where(np.arange(s)[None] <= np.asarray(pos)[:, None], 0.0,
                    NEG_INF_BIAS).astype(np.float32)
    return (q, _codes(rng, (b, s, hkv, hd)), _scales(rng, (b, s, hkv)),
            _codes(rng, (b, s, hkv, hd)), _scales(rng, (b, s, hkv)), bias)


def _int4_pools(rng, n, bs, hkv, hd):
    """Packed int4 pools (every byte, so every nibble -8..7) with f16 group
    scales of dequantized values of order 1, as int4 K/V are."""
    def codes():
        return rng.integers(-128, 128, (n, bs, hkv, hd // 2)).astype(np.int8)

    def scales():
        return (rng.uniform(0.5, 1.5, (n, bs, hkv, hd // KV_GROUP))
                / 7).astype(np.float16)
    return codes(), scales(), codes(), scales()


def _paged_case(seed, b, hkv, g, hd, bs, m, pos, holes=(), fmt="int8"):
    """Shuffled block ids up to each position (block 0 is the trash block);
    an idle row (pos -1) has an all -1 table at position 0."""
    rng = np.random.default_rng(seed)
    n = b * m + 3
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    pools = (_codes(rng, (n, bs, hkv, hd)), _scales(rng, (n, bs, hkv)),
             _codes(rng, (n, bs, hkv, hd)), _scales(rng, (n, bs, hkv))) \
        if fmt == "int8" else _int4_pools(rng, n, bs, hkv, hd)
    ids = iter(rng.permutation(np.arange(1, n)))
    tables = np.full((b, m), -1, np.int32)
    for i, p in enumerate(pos):
        for j in range(p // bs + 1 if p >= 0 else 0):
            tables[i, j] = next(ids)
    for i, j in holes:
        tables[i, j] = -1
    return (q, *pools, tables, np.asarray([max(p, 0) for p in pos], np.int32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# (B, S, Hkv, G, hd, positions, splits): n_keys 1, 31, 32, 33; positions
# one before, at and after a share boundary (2 tiles a CTA at S 256 and 8
# splits, so a boundary every 64 slots) and the last slot; G 1, 4, 8 at hd
# 64, 96, 128; a row whose every slot is masked
DENSE = {
    "s1": (2, 1, 2, 1, 64, [0, 0], None),
    "s31": (2, 31, 2, 4, 96, [30, 5], None),
    "s32": (2, 32, 2, 8, 128, [31, 0], None),
    "s33": (2, 33, 2, 1, 64, [32, 31], None),
    "share_edges": (3, 256, 2, 4, 64, [63, 64, 65], 4),
    "share_edges_8": (3, 513, 1, 8, 96, [127, 128, 512], 8),
    "masked_row": (3, 100, 2, 4, 64, [-1, 50, 99], 4),
}


@pytest.mark.parametrize("case", sorted(DENSE))
def test_dense_model_matches_plain_and_pallas(case):
    b, s, hkv, g, hd, pos, splits = DENSE[case]
    arrays = _dense_case(len(case) + s, b, s, hkv, g, hd, pos)
    got = model_qdecode(*_t(*arrays), splits=splits)
    want = t_ref.qdecode_ref(*_t(*arrays))
    pallas = np.asarray(qdecode_attention(*_j(*arrays), interpret=True))
    assert got.shape == want.shape and torch.isfinite(got).all()
    # f32 throughout; the kernel scales after the dot, the plain version
    # dequantizes first, and the summation orders differ
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=0)


# (B, Hkv, G, hd, bs, M, positions, holes, splits): n_keys = pos + 1 of 1,
# 31, 32, 33; share boundaries +-1; M * bs exactly; bs 1, 16, 32; tables
# with -1 holes; idle rows (pos -1); G 1, 4, 8 at hd 64, 96, 128
PAGED = {
    "bs16_edges": (4, 2, 1, 64, 16, 4, [0, 30, 31, 32], (), None),
    "bs1_edges": (3, 2, 4, 96, 1, 40, [32, 31, 39], [(0, 5)], None),
    "bs32_full": (2, 2, 8, 128, 32, 3, [95, 64], [(1, 1)], None),
    "share_edges": (3, 1, 4, 64, 16, 16, [63, 64, 65], [(2, 3)], 8),
    "idle": (4, 2, 1, 64, 16, 8, [100, -1, 31, 127], [(0, 1)], None),
    "idle_g8": (2, 1, 8, 96, 32, 4, [-1, 127], (), 4),
}
# the same kinds over int4 pools (hd a multiple of 32), plus hd 32: one
# group, a masked lane at G bound 1
PAGED4 = {"q4_" + key: case for key, case in PAGED.items()}
PAGED4["q4_hd32"] = (3, 2, 1, 32, 8, 8, [63, 20, 7], [(1, 1)], None)
# (plain version, Pallas kernel) by format
ORACLES = {"int8": (t_ref.paged_qdecode_ref, paged_qdecode_attention),
           "int4": (t_ref.paged_q4decode_ref, paged_q4decode_attention)}


@pytest.mark.parametrize("case", sorted(PAGED) + sorted(PAGED4))
def test_paged_model_matches_plain_and_pallas(case):
    fmt = "int4" if case in PAGED4 else "int8"
    b, hkv, g, hd, bs, m, pos, holes, splits = {**PAGED, **PAGED4}[case]
    plain, kernel = ORACLES[fmt]
    arrays = _paged_case(len(case) * bs, b, hkv, g, hd, bs, m, pos, holes,
                         fmt)
    got = model_paged(*_t(*arrays), splits=splits, fmt=fmt)
    want = plain(*_t(*arrays))
    live = torch.tensor([p >= 0 for p in pos])
    # an idle row is 0/0 on both sides, and nothing else is
    assert torch.equal(got.isnan().flatten(1).all(1), ~live)
    assert torch.equal(want.isnan().flatten(1).all(1), ~live)
    assert torch.isfinite(got[live]).all()
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(),
                               atol=1e-4, rtol=0)
    pallas = np.asarray(kernel(*_j(*arrays), interpret=True))
    np.testing.assert_allclose(got[live].numpy(), pallas[live.numpy()],
                               atol=1e-4, rtol=0)


def test_paged_model_stages_long_tables_in_chunks():
    """At bs 1 a chunk of TAB_CAP staged entries is 512 slots: one
    sequence of 4500 keys at 1 split walks 9 chunks, a hole in the 2nd;
    over int8 and int4 pools."""
    assert C["TAB_CAP"] == 512
    for fmt in ("int8", "int4"):
        arrays = _paged_case(11, 2, 1, 1, 32, 1, 4600, [4499, 600],
                             [(0, 700)], fmt)
        got = model_paged(*_t(*arrays), splits=1, fmt=fmt)
        want = ORACLES[fmt][0](*_t(*arrays))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=0)


def _fp_case(seed, b, hkv, g, hd, bs, m, pos, holes, dtype):
    """``_paged_case``'s tables and q over bf16 or f32 pools of N(0, 1)
    values, as torch tensors of ``dtype`` (q in ``dtype`` too)."""
    q, k_i8, _, v_i8, _, tables, pos_ = _paged_case(seed, b, hkv, g, hd, bs,
                                                    m, pos, holes)
    rng = np.random.default_rng(seed + 1)
    k_pool, v_pool = (torch.from_numpy(rng.normal(size=k_i8.shape).astype(
        np.float32)).to(dtype) for _ in range(2))
    return (torch.from_numpy(q).to(dtype), k_pool, v_pool,
            *_t(tables, pos_))


def _fp_model(q, k_pool, v_pool, tables, pos, splits=None):
    return model_paged(q, k_pool, None, v_pool, None, tables, pos,
                       splits=splits, fmt="fp")


# the fp pools' cases: hd 32..128 (8 to 16 lanes a row), G 1, 4, 8, blocks
# of 1, 16 and 32 slots, holes, idle rows and share boundaries
PAGEDFP = {
    "fp_hd32_g1": (3, 2, 1, 32, 8, 8, [63, 20, 7], [(1, 1)], None),
    "fp_hd64_g4": (4, 2, 4, 64, 16, 4, [0, 30, 31, 32], (), None),
    "fp_hd96_g8_idle": (2, 1, 8, 96, 32, 4, [-1, 127], (), 4),
    "fp_hd128_g8_bs1": (3, 2, 8, 128, 1, 40, [32, 31, 39], [(0, 5)], None),
    "fp_hd128_g1_edges": (3, 1, 1, 128, 16, 16, [63, 64, 65], [(2, 3)], 8),
    "fp_hd40_g4_idle": (4, 2, 4, 40, 16, 8, [100, -1, 31, 127], [(0, 1)],
                        None),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(PAGEDFP))
def test_fp_paged_model_matches_plain_and_pallas(case, dtype):
    """bf16 and f32 pools, q of the same dtype: the model against
    ``paged_decode_ref`` and the Pallas kernel on the same values."""
    b, hkv, g, hd, bs, m, pos, holes, splits = PAGEDFP[case]
    args = _fp_case(len(case) * bs, b, hkv, g, hd, bs, m, pos, holes, dtype)
    got = _fp_model(*args, splits=splits)
    want = t_ref.paged_decode_ref(*args)
    live = torch.tensor([p >= 0 for p in pos])
    assert torch.equal(got.isnan().flatten(1).all(1), ~live)
    assert torch.equal(want.isnan().flatten(1).all(1), ~live)
    assert torch.isfinite(got[live]).all()
    # f32 throughout (bf16 elements are exact in f32); summation orders
    # differ
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(),
                               atol=1e-4, rtol=0)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, k_pool, v_pool, tables, pos_t = args
    pallas = np.asarray(paged_decode_attention(
        *(jnp.asarray(t.float().numpy(), jdt) for t in (q, k_pool, v_pool)),
        jnp.asarray(tables.numpy()), jnp.asarray(pos_t.numpy()),
        interpret=True))
    np.testing.assert_allclose(got[live].numpy(), pallas[live.numpy()],
                               atol=1e-4, rtol=0)


def test_poisoned_trash_block_leaves_live_rows_bit_identical():
    """What an idle slot writes into block 0 is never read: NaN scales
    and -128 codes (int8), NaN f16 scales and 0x88 bytes (int4: codes -8)
    or NaN elements (bf16 and f32 pools). The live rows do not change, in
    the model and the plain version alike."""
    b, hkv, g, hd, bs, m, pos, holes, splits = PAGED["idle"]
    live = torch.tensor([p >= 0 for p in pos])
    for fmt, poison in (("int8", -128), ("int4", -120)):
        plain = ORACLES[fmt][0]
        arrays = list(_t(*_paged_case(5, b, hkv, g, hd, bs, m, pos, holes,
                                      fmt)))
        before = model_paged(*arrays, splits=splits, fmt=fmt)
        before_ref = plain(*arrays)
        k_pool, k_scale, v_pool, v_scale = (t.clone() for t in arrays[1:5])
        k_pool[0], v_pool[0] = poison, poison
        k_scale[0], v_scale[0] = float("nan"), float("nan")
        arrays[1:5] = k_pool, k_scale, v_pool, v_scale
        after = model_paged(*arrays, splits=splits, fmt=fmt)
        assert torch.equal(after[live], before[live])
        assert torch.isfinite(after[live]).all()
        assert torch.equal(plain(*arrays)[live], before_ref[live])
    # bf16 and f32 pools: NaN rows in block 0
    for dtype in (torch.bfloat16, torch.float32):
        args = list(_fp_case(5, b, hkv, g, hd, bs, m, pos, holes, dtype))
        before = _fp_model(*args, splits=splits)
        before_ref = t_ref.paged_decode_ref(*args)
        args[1], args[2] = args[1].clone(), args[2].clone()
        args[1][0], args[2][0] = float("nan"), float("nan")
        after = _fp_model(*args, splits=splits)
        assert torch.equal(after[live], before[live])
        assert torch.isfinite(after[live]).all()
        assert torch.equal(t_ref.paged_decode_ref(*args)[live],
                           before_ref[live])


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_empty_shares_contribute_nothing(splits):
    """33 keys are 2 tiles: at 4 and 8 splits ranks 2.. hold no slot and
    contribute m = RUN_INIT, l = 0, acc = 0; every split count gives the
    one-CTA result."""
    arrays = _t(*_dense_case(3, 2, 33, 2, 4, 64, [32, 7]))
    one = model_qdecode(*arrays, splits=1)
    got = model_qdecode(*arrays, splits=splits)
    torch.testing.assert_close(got, one, atol=1e-6, rtol=0)


def test_minus_inf_seeds_would_poison_the_merge():
    """The trap the RUN_INIT seed avoids: an empty partial seeded at -inf
    beside another empty one gives exp(-inf - -inf) = NaN, while RUN_INIT
    gives a weight of 1 times l = 0."""
    def merge(parts):                    # rank 0's max, then the others'
        mx = parts[0][0]
        for mr, _ in parts[1:]:
            mx = torch.maximum(mx, mr)
        return sum(lr * torch.exp(mr - mx) for mr, lr in parts)

    inf = torch.tensor(-math.inf)
    seed = torch.tensor(C["RUN_INIT"])
    zero = torch.tensor(0.0)
    assert merge([(seed, zero), (seed, zero)]) == 0
    mx = torch.maximum(inf, inf)
    assert torch.isnan(torch.exp(inf - mx))
    live = (torch.tensor(3.0), torch.tensor(2.0))
    assert merge([(seed, zero), live, (seed, zero)]) == 2.0


# ------------------------------------------------------------------ #
# The wide class (qdecode: G up to 16, hd up to 256)
# ------------------------------------------------------------------ #
QDECODE_CU = CUH.parent / "qdecode.cu"


def _wide_constants():
    """The wide body's ``constexpr int WIDE_*`` of qdecode.cu, evaluated in
    order."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (WIDE_\w+) = ([^;]+);",
                                 QDECODE_CU.read_text(), flags=re.M):
        expr = re.sub(r"\((\w+) > (\w+) \? (\w+)\s*: (\w+)\)",
                      r"(\3 if \1 > \2 else \4)", expr)
        env[name] = int(eval(expr, {}, dict(env)))
    return env


W = _wide_constants()


def test_wide_class_constants_and_dispatch_mirror_the_source():
    """The wide class is its own body in qdecode.cu (the header keeps the
    split classes' MAXG / MAXD of 8 / 128 and no wide constant): one CTA
    holds all WIDE_G query heads as one m16 tile, its WIDE_NW warps walk
    WIDE_KT-slot tiles with WIDE_ST a warp in its ring, clusters of up to
    WIDE_SPLITS CTAs, and its shared memory (Q's fragments, the warps'
    rings, then the partials over the ring) fits the card. The rows' strides put one fragment load's 8 lanes of a phase on
    8 distinct 16-byte bank groups, and the head-dim permutations of both
    products cover every dim once."""
    assert (C["MAXG"], C["MAXD"]) == (8, 128)
    assert "WIDE" not in CUH.read_text()
    assert (W["WIDE_G"], W["WIDE_D"], W["WIDE_NW"], W["WIDE_KT"],
            W["WIDE_ST"], W["WIDE_SPLITS"]) == (16, 256, 8, 16, 2, 16)
    assert qdecode.WIDE_GROUP == W["WIDE_G"]
    assert qdecode.WIDE_HEAD_DIM == W["WIDE_D"]
    assert W["WIDE_SMEM"] <= 227 * 1024
    assert W["WIDE_MERGE"] <= W["WIDE_RING"]
    src = " ".join(QDECODE_CU.read_text().split())
    for line in ("if (G <= ds::MAXG && hd <= ds::MAXD) return "
                 "ds::dispatch<ds::Int8>(go, hd, G); if "
                 "(reinterpret_cast<uintptr_t>(q) % 16) return "
                 "(int)cudaErrorInvalidValue; return go.run_wide();",
                 "wide_splits(S, pairs, resident, pairs <= cluster16 ? "
                 "WIDE_SPLITS : ds::MAX_SPLITS)",
                 "while (s < max_splits && s * ds::KT < n_keys_max && "
                 "pairs * 2 * s <= resident)",
                 "float m_lo = ds::RUN_INIT_BIAS, m_hi = ds::RUN_INIT_BIAS;"):
        assert line in src, line
    for g, hd in ((1, 64), (8, 128), (4, 96)):
        assert not qdecode.wide_class(g, hd)
    for g, hd in ((16, 256), (9, 64), (8, 144), (12, 192)):
        assert qdecode.wide_class(g, hd)
    # one phase of a 16-byte shared load: lanes 0..7, (gid, tig) = (l // 4,
    # l % 4). K: chunk 4c + tig of rows gid; V: chunk gid of rows 2 tig
    ks, vs = W["WIDE_KS"] // 16, W["WIDE_VS"] // 16
    for base in (0, 8, 16, 24):
        lanes = [(lane >> 2, lane & 3) for lane in range(base, base + 8)]
        assert len({(gid * ks + tig) % 8 for gid, tig in lanes}) == 8
        assert len({(2 * tig * vs + gid) % 8 for gid, tig in lanes}) == 8
    # Q K^T: k-step 4c + w gives lane (gid, tig) dims 64c + 16 tig + 4w + 0..3
    dims = sorted(64 * c + 16 * t + 4 * w + e for c in range(4)
                  for w in range(4) for t in range(4) for e in range(4))
    assert dims == list(range(256))
    # P'V: n-block 16 hh + j, column n holds dim 16 n + j + 128 hh
    dims = sorted(16 * n + j + 128 * hh for hh in range(2) for j in range(16)
                  for n in range(8))
    assert dims == list(range(256))


def wide_splits(n_keys_max, pairs, resident, max_splits=None):
    """The wide body's splits: the split rule up to WIDE_SPLITS (a
    non-portable cluster where the card schedules it)."""
    s = 1
    while (s < (max_splits or W["WIDE_SPLITS"]) and s * KT < n_keys_max
           and pairs * 2 * s <= resident):
        s *= 2
    return s


def wide_share(n_keys, splits, rank):
    kt = W["WIDE_KT"]
    per = -(-(-(-n_keys // kt)) // splits)
    k0 = min(rank * per * kt, n_keys)
    return k0, min(k0 + per * kt, n_keys)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def model_qdecode_wide(q, k_i8, k_s, v_i8, v_s, bias, splits=None):
    """The wide body's plan: one cluster per (sequence, kv head) holding all
    G query heads, each CTA a share of whole WIDE_KT-slot tiles, tile i to
    warp i % WIDE_NW. A warp's tile: S = Q K^T with Q in bf16 (f32 q as hi
    + lo, two products; the codes exact), scores (acc * k_s) / sqrt(hd) +
    bias (-inf past the share), each head's online softmax (max seeded at
    RUN_INIT_BIAS, rescaled when it moves), O += (hi + lo) V over p' = p *
    v_s split in two bf16 terms; then the warps' merge and the cluster's in
    rank order."""
    b, s, hkv, hd = k_i8.shape
    g = q.shape[2]
    nw, kt = W["WIDE_NW"], W["WIDE_KT"]
    splits = splits or wide_splits(s, b * hkv, 10 ** 9)
    scale = torch.sqrt(torch.tensor(float(hd)))
    qf = q.float()
    q_hi = _bf16(qf)
    q_lo = _bf16(qf - q_hi)
    out = torch.empty((b, hkv, g, hd))
    for i in range(b):
        for h in range(hkv):
            kf, vf = k_i8[i, :, h].float(), v_i8[i, :, h].float()
            parts = []
            for rank in range(splits):
                k0, k1 = wide_share(s, splits, rank)
                m = torch.full((nw, g), C["RUN_INIT_BIAS"])
                lsum = torch.zeros((nw, g))
                acc = torch.zeros((nw, g, hd))
                for t in range(-(-(k1 - k0) // kt)):
                    w = t % nw
                    keys = torch.arange(k0 + t * kt, k0 + (t + 1) * kt)
                    on = keys < k1
                    kk = keys.clamp(max=s - 1)
                    kc = torch.where(on[:, None], kf[kk], 0.0)
                    vc = torch.where(on[:, None], vf[kk], 0.0)
                    dot = q_hi[i, h] @ kc.T + q_lo[i, h] @ kc.T
                    sc = torch.where(on[None], dot * k_s[i, kk, h] / scale
                                     + bias[i, kk], -math.inf)
                    mx = sc.amax(-1)
                    moved = mx > m[w]
                    alpha = torch.where(moved, torch.exp(m[w] - mx),
                                        torch.ones(()))
                    m[w] = torch.where(moved, mx, m[w])
                    lsum[w] = lsum[w] * alpha
                    acc[w] = acc[w] * alpha[:, None]
                    p = torch.exp(sc - m[w][:, None])
                    lsum[w] = lsum[w] + p.sum(-1)
                    pv = p * torch.where(on, v_s[i, kk, h], 0.0)[None]
                    hi = _bf16(pv)
                    acc[w] = acc[w] + hi @ vc + _bf16(pv - hi) @ vc
                mc = m.amax(0)                       # the warps' merge
                f = torch.exp(m - mc)
                parts.append((mc, (lsum * f).sum(0),
                              (acc * f[..., None]).sum(0)))
            mx = parts[0][0]
            for mr, _, _ in parts[1:]:               # the cluster's merge
                mx = torch.maximum(mx, mr)
            ls, a = torch.zeros(g), torch.zeros((g, hd))
            for mr, lr, ar in parts:
                f = torch.exp(mr - mx)
                ls = ls + lr * f
                a = a + ar * f[:, None]
            out[i, h] = a / ls[:, None]
    return out


# (B, S, Hkv, G, hd, positions, splits): recurrentgemma's 16 x 256 over
# one kv head (a ring's positions), G 12 at hd 192 (heads past G and
# dims past hd zero), G 9 at hd 64, G 8 at hd 256, a row whose every
# slot is masked (averaged uniformly, as the plain softmax does)
WIDE = {
    "g16_hd256": (2, 96, 1, 16, 256, [95, 40], None),
    "g12_hd192": (2, 65, 2, 12, 192, [64, 0], 4),
    "g9_hd64": (1, 33, 1, 9, 64, [32], 2),
    "g8_hd256": (2, 40, 1, 8, 256, [10, 39], 8),
    "g16_masked_row": (2, 70, 1, 16, 256, [-1, 69], 4),
}


@pytest.mark.parametrize("case", sorted(WIDE))
def test_wide_model_matches_plain_and_pallas(case):
    b, s, hkv, g, hd, pos, splits = WIDE[case]
    arrays = _dense_case(len(case) + s, b, s, hkv, g, hd, pos)
    got = model_qdecode_wide(*_t(*arrays), splits=splits)
    want = t_ref.qdecode_ref(*_t(*arrays))
    pallas = np.asarray(qdecode_attention(*_j(*arrays), interpret=True))
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=0)
    # bf16 q: exact in one bf16 term, one product
    q16 = _t(*arrays)[0].to(torch.bfloat16)
    rest = _t(*arrays)[1:]
    np.testing.assert_allclose(
        model_qdecode_wide(q16, *rest, splits=splits).numpy(),
        t_ref.qdecode_ref(q16, *rest).numpy(), atol=1e-4, rtol=0)
