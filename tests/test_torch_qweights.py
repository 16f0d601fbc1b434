"""The port's per-channel int8 weight quantizer against the JAX package's:
``ref.quantize_ref`` and ``ops.quantize_weights`` on CPU tensors (the plain
version) against the Pallas ``quantize_weights`` in interpret mode and the
JAX oracle ``ref.quantize_ref``. The CUDA kernel is held against the plain
version in test_torch_cuda.py.

Codes are bit-identical to both. Scales are bit-identical to the oracle,
which divides ``absmax / 127`` (IEEE), as the port does. The Pallas kernel
runs under ``jax.jit``, where XLA rewrites the division by the constant
into ``absmax * f32(1 / 127)``: its scales are exactly that product, one
ulp off the quotient in some columns (the JAX package's own test holds
kernel and oracle scales at rtol 1e-6 for this reason).

The card kernel's plan (route, strip width, cluster size, K-slices, load
mode) is checked here too, with its layout constants read from
``csrc/quantize_weights.cu`` so the two cannot drift, and its cluster
route (per-rank partial maxima, their max, each rank's codes) is emulated
in torch and held to the Pallas kernel and the oracle."""
import ast
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import quantize as j_quantize  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as t_quantize  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

# the JAX package's own test shapes: ragged N (33, 96) and K (300, 48)
SHAPES = [(64, 64), (300, 96), (1024, 512), (48, 33)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(w: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounds once, in JAX, and the torch tensor takes its bits)."""
    jdt, tdt = DTYPES[dtype]
    wj = jnp.asarray(w, jdt)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(tdt)
    return wj, wt


def _assert_bit_identical(got, want):
    codes, scale = got
    want_codes, want_scale = (np.asarray(a) for a in want)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(scale.shape) == want_scale.shape
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  want_scale.view(np.uint32))


def _assert_matches_pallas(got, w32: np.ndarray, pallas):
    """Codes bit for bit; scales the IEEE quotient where the Pallas kernel
    has the reciprocal product, each exactly, and at most 1 ulp apart."""
    codes, scale = got
    np.testing.assert_array_equal(codes.numpy(), np.asarray(pallas[0]))
    absmax = np.maximum(np.abs(w32).max(axis=0, keepdims=True),
                        np.float32(1e-12))
    quotient = absmax / np.float32(127)
    product = absmax * np.float32(1 / 127)
    want = np.asarray(pallas[1])
    np.testing.assert_array_equal(want.view(np.uint32),
                                  product.view(np.uint32))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  quotient.view(np.uint32))
    ulps = np.abs(scale.numpy().view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= 1


def _edge_columns(k: int, n: int, seed: int) -> np.ndarray:
    """Random columns, one all-zero column, and columns whose ``w * inv``
    lands exactly on k + 0.5: absmax 127 (inv 1) with values k + 0.5, and
    absmax 63.5 (inv 2) with values k / 2 + 0.25."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 3, (k, n)).astype(np.float32)
    w[:, 1] = 0.0
    w[:, 2] = rng.integers(-126, 126, k) + 0.5
    w[0, 2] = 127.0
    w[:, 3] = (rng.integers(-126, 126, k) + 0.5) / 2
    w[0, 3] = 63.5
    w[:, 4] = -w[:, 2]
    return w


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_weights_matches_pallas_and_oracle(shape, dtype):
    w = np.random.default_rng(sum(shape)).normal(0, 3, shape)
    wj, wt = _pair(w.astype(np.float32), dtype)
    oracle = j_ref.quantize_ref(wj.astype(jnp.float32))
    pallas = j_quantize.quantize_weights(wj, interpret=True)
    w32 = wt.to(torch.float32).numpy()
    for got in (t_ref.quantize_ref(wt), ops.quantize_weights(wt)):
        _assert_bit_identical(got, oracle)
        _assert_matches_pallas(got, w32, pallas)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_weights_edge_columns(dtype):
    wj, wt = _pair(_edge_columns(96, 40, seed=3), dtype)
    oracle = j_ref.quantize_ref(wj.astype(jnp.float32))
    pallas = j_quantize.quantize_weights(wj, interpret=True)
    got = ops.quantize_weights(wt)
    for out in (got, t_ref.quantize_ref(wt)):
        _assert_bit_identical(out, oracle)
        _assert_matches_pallas(out, wt.to(torch.float32).numpy(), pallas)
    codes, scale = got
    # the zero column: codes 0 and the floored scale
    assert int(codes[:, 1].abs().max()) == 0
    assert scale[0, 1].item() == np.float32(1e-12) / np.float32(127)
    # .5 quotients round half to even, on both signs
    halves = wt[:, 2].to(torch.float32)
    assert torch.equal(codes[:, 2].to(torch.float32), torch.round(halves))
    assert torch.equal(codes[:, 4], -codes[:, 2])
    assert int(codes[:, 2].abs().max()) == 127


def test_quantize_weights_checks_operands():
    """The kernel entry checks its operands (``ops.quantize_weights`` now
    reaches it only under the ``cuda`` backend, which refuses CPU tensors
    first); ``ops`` under the CPU's default backend takes the plain
    version and counts no launch."""
    from repro_torch.api.backends import use_backend

    before = t_quantize.quantize_weights.launches
    with pytest.raises(ValueError, match=r"\[K, N\]"):
        t_quantize.quantize_weights(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_quantize.quantize_weights(torch.zeros(4, 4, dtype=torch.float16))
    with pytest.raises(ValueError, match="no quantize_weights kernel"):
        t_quantize.quantize_weights(torch.zeros(4, 4, device="meta"))
    with use_backend("cuda"), pytest.raises(ValueError, match="cpu"):
        ops.quantize_weights(torch.ones(4, 4))
    # the plain version counts no launch
    t_quantize.quantize_weights(torch.ones(4, 4))
    ops.quantize_weights(torch.ones(4, 4))
    assert t_quantize.quantize_weights.launches == before


# ------------------------------------------------------------------ #
# The card kernel's plan and its cluster route, emulated on the CPU
# ------------------------------------------------------------------ #
CU = (Path(t_quantize.__file__).resolve().parents[1] / "csrc"
      / "quantize_weights.cu")
ROOT = Path(__file__).resolve().parents[1]
MAX_SMEM = 227 * 1024          # the H100's shared memory a CTA can have
ELEM = {torch.bfloat16: 2, torch.float32: 4}


def _cu_constants():
    """Every namespace-level ``constexpr int NAME = expr;`` of the source,
    evaluated in order."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 CU.read_text(), flags=re.M):
        env[name] = int(eval(expr, {}, dict(env)))
    return env


def _qw_shapes():
    """``chip_smoke.py``'s QW_SHAPES, read from its source."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "QW_SHAPES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no QW_SHAPES")


C = _cu_constants()
QW_SHAPES = _qw_shapes()
# (K, N): chip_smoke.py's shapes, the card tests' (every cluster size; the
# two-pass route's 30000 x 64), the GEMMs' weight shapes, the edges of
# the cluster route in each dtype, and ragged ones
PLAN_KN = sorted(set(QW_SHAPES) | {
    *((8 * c - 3, 200) for c in range(1, 9)), (30000, 64),
    (2048, 2048), (2048, 11264), (5632, 2048), (2048, 100352),
    (64, 64), (1024, 512), (96, 40), (1, 1), (7, 4096), (25000, 33),
    (14500, 3072), (14600, 3072), (29000, 96), (29100, 96)})


def test_python_mirrors_the_source_constants():
    q = t_quantize
    assert q.W == C["W"] >= 32           # a code row: one 32-byte sector
    assert q.CLUSTER_MAX == C["CLUSTER_MAX"] <= 8      # portable clusters
    assert q.BOX_MAX == C["BOX_MAX"] <= 256            # TMA's box limit
    assert q.BOX_ALIGN == C["BOX_ALIGN"]
    assert q.SMEM_ALIGN == C["SMEM_ALIGN"]
    assert q.SMEM_CAP == C["SMEM_CAP"] <= MAX_SMEM
    assert q.TWO_PASS_TC == C["TC"]
    src = " ".join(CU.read_text().split())
    # the smem formula is the source's
    assert ("return (size_t)SMEM_ALIGN + (size_t)rows * W * elem + "
            "8 * (size_t)(rows / box) + 8 * (size_t)W;") in src
    # one cluster kernel a dtype, both dispatched
    assert "return launch_cluster<float>(" in src
    assert "return launch_cluster<__nv_bfloat16>(" in src


def _ranks(p, k):
    """[r0, r1) of each rank of a cluster plan, as the kernel takes them."""
    return [(r * p.rows, min(k, (r + 1) * p.rows)) for r in range(p.cluster)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", PLAN_KN)
def test_plan_layout(k, n, dtype, aligned):
    """Slices partition [0, K) once; a CTA fits the card; c <= 8, W >= 32;
    c = 8, the most CTAs, wherever K has the rows (strips x c then reach
    132 from N = 528 up); two passes only where a strip outgrows
    CLUSTER_MAX CTAs of SMEM_CAP."""
    q, e = t_quantize, ELEM[dtype]
    p = q.plan(k, n, dtype, aligned)
    pitch = aligned and n * e % 16 == 0
    rows8, box8 = q.slice_rows(k, q.CLUSTER_MAX)
    if q.cluster_smem(rows8, box8, e) > q.SMEM_CAP:
        width = q.TWO_PASS_TC * (16 // e if pitch else 1)
        assert p == q.Plan("two_pass", width, 1, k, 0,
                           "vec" if pitch else "scalar")
        return
    assert p.route == "cluster" and p.load == ("tma" if pitch else "plain")
    assert p.width == q.W >= 32
    assert p.cluster == min(q.CLUSTER_MAX, -(-k // q.BOX_ALIGN)) <= 8
    assert p.box % q.BOX_ALIGN == 0 and 0 < p.box <= q.BOX_MAX
    assert p.rows % p.box == 0
    covered = np.zeros(k, np.int64)
    for r0, r1 in _ranks(p, k):
        covered[r0:r1] += 1
    np.testing.assert_array_equal(covered, 1)
    assert q.cluster_smem(p.rows, p.box, e) <= MAX_SMEM
    if n >= 528 and k > 56:
        assert -(-n // p.width) * p.cluster >= 132


# chip_smoke.py's shapes: (route, W, c, rows, box, load) by dtype, aligned.
# Every cluster plan takes c 8 but the 48-row one (6 boxes of 8 rows);
# plain loads where N * elem is not a multiple of 16 bytes; wo [8192,
# 3072] in f32 needs 132 KB a CTA (one CTA an SM); the stablelm embedding
# [100352, 2048] is the two-pass route
WANT_PLANS = {
    (3072, 3072): ("cluster", 32, 8, 384, 192, "tma"),
    (3072, 16384): ("cluster", 32, 8, 384, 192, "tma"),
    (8192, 3072): ("cluster", 32, 8, 1024, 256, "tma"),
    (1024, 3072): ("cluster", 32, 8, 128, 128, "tma"),
    (3072, 32064): ("cluster", 32, 8, 384, 192, "tma"),
    (48, 33): ("cluster", 32, 6, 8, 8, "plain"),
    (300, 96): ("cluster", 32, 8, 40, 40, "tma"),
    (100352, 2048): {"bfloat16": ("two_pass", 32, 1, 100352, 0, "vec"),
                     "float32": ("two_pass", 16, 1, 100352, 0, "vec")},
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", QW_SHAPES)
def test_chip_smoke_shapes_take_their_plan(shape, dtype):
    assert set(QW_SHAPES) == set(WANT_PLANS)
    want = WANT_PLANS[shape]
    want = want[dtype] if isinstance(want, dict) else want
    assert tuple(t_quantize.plan(*shape, getattr(torch, dtype))) == want


def _emulate_cluster(w: torch.Tensor, p):
    """The cluster route in torch: each rank's partial maxima over its
    slice, box by box (zeros past N), their max, and each rank's codes
    from its own slice."""
    k, n = w.shape
    x = w.to(torch.float32)
    strips = -(-n // p.width)
    padded = torch.zeros((k, strips * p.width))
    padded[:, :n] = x
    codes = torch.full((k, strips * p.width), 99, dtype=torch.int8)
    scale = torch.empty(strips * p.width)
    floor, top = torch.tensor(1e-12), torch.tensor(127.0)
    for s in range(strips):
        cols = padded[:, s * p.width:(s + 1) * p.width]
        parts = []
        for r0, r1 in _ranks(p, k):
            part = torch.zeros(p.width)
            for b0 in range(r0, r1, p.box):
                part = torch.maximum(
                    part, cols[b0:min(b0 + p.box, r1)].abs().amax(0))
            parts.append(part)
        absmax = torch.maximum(torch.stack(parts).amax(0), floor)
        inv = top / absmax                # every rank: the same bits
        for r0, r1 in _ranks(p, k):
            codes[r0:r1, s * p.width:(s + 1) * p.width] = torch.clamp(
                torch.round(cols[r0:r1] * inv), -127, 127).to(torch.int8)
        scale[s * p.width:(s + 1) * p.width] = absmax / top
    return codes[:, :n], scale[None, :n]


# (K, N, c): K sets the cluster size (c = 8 from 57 rows up), K not a
# multiple of c, a late rank with fewer rows (13 at c 2: 8 + 5; 61 at c 8:
# the last rank 5 of its 8) or none (48 at c 6 holds 6 x 8; 300 at c 8:
# 7 x 40 + 20); N a full strip and a ragged one, or one ragged strip
EMU_CASES = [(13, 40, 2), (20, 33, 3), (48, 96, 6), (61, 200, 8),
             (300, 96, 8), (300, 200, 8), (1024, 72, 8)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,n,c", EMU_CASES)
def test_cluster_route_emulation_matches_pallas_and_oracle(k, n, c, dtype):
    p = t_quantize.plan(k, n, DTYPES[dtype][1])
    assert (p.route, p.cluster) == ("cluster", c)
    w = _edge_columns(k, n, seed=k + n + c)
    wj, wt = _pair(w, dtype)
    got = _emulate_cluster(wt, p)
    _assert_bit_identical(got, j_ref.quantize_ref(wj.astype(jnp.float32)))
    _assert_matches_pallas(got, wt.to(torch.float32).numpy(),
                           j_quantize.quantize_weights(wj, interpret=True))
    want = t_ref.quantize_ref(wt)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
