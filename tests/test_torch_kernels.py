"""Port kernels vs the JAX Pallas kernels: the port's plain versions (what
its wrappers run for CPU tensors) against ``repro.kernels`` run in
interpret mode on the same numpy inputs, and the wrappers' checks. The
CUDA kernels are held against the plain versions in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import dynquant as j_dynquant  # noqa: E402
from repro.kernels import qmatmul as j_qmatmul  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill_attention  # noqa: E402
from repro_torch.kernels import dynquant, flash_prefill, ops, qmatmul  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

# ragged M/K/N: no dimension a multiple of the TPU blocks or the CUDA tiles
GEMM_SHAPES = [(7, 48, 33), (130, 257, 129), (1, 128, 256)]


def _bf16_with_half_quotients(m, k, seed):
    """bf16 activations where many codes sit exactly on .5: half the rows
    have absmax 127 (dynamic inv = 127/127 = 1) and hold k + 0.5 values, so
    round-half-even decides them; the other rows are random."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (m, k)).astype(np.float32)
    half = rng.integers(-126, 126, (m, k)) + 0.5
    rows = np.arange(m) % 2 == 0
    x[rows] = half[rows]
    x[rows, 0] = 127.0
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)


def _weights(k, n, seed):
    w = jax.random.normal(jax.random.PRNGKey(seed), (k, n), jnp.float32)
    w_i8, w_s = j_ref.quantize_ref(w)
    return (w_i8, w_s, torch.from_numpy(np.array(w_i8)),
            torch.from_numpy(np.array(w_s)))


def _jax_dynamic_codes(x):
    """The TPU kernel's activation codes (``dynquant._kernel`` lines 22-26)."""
    xf = x.astype(jnp.float32)
    absmax = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True), 1e-12)
    return jnp.clip(jnp.round(xf * (127.0 / absmax)), -127, 127).astype(
        jnp.int8)


@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_qmatmul_dynamic_matches_pallas(shape):
    m, k, n = shape
    xj, xt = _bf16_with_half_quotients(m, k, seed=m + k)
    w_i8, w_s, tw_i8, tw_s = _weights(k, n, seed=n)
    # codes: bit-identical, including the .5 quotients (round half to even)
    codes, a_scale = t_ref.quantize_rows_ref(xt)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jax.jit(_jax_dynamic_codes)(xj)))
    xf = xt.float().numpy()
    quot = xf * (np.float32(127.0) / np.abs(xf).max(axis=1, keepdims=True))
    assert (np.abs(quot - np.trunc(quot)) == 0.5).sum() >= k // 2
    # outputs: same int32 sums, same epilogue order -> rtol 1e-6 leaves room
    # for one f32 rounding of the scale products and nothing else
    got = dynquant.qmatmul_dynamic(xt, tw_i8, tw_s).numpy()
    want = np.asarray(j_dynquant.qmatmul_dynamic(xj, w_i8, w_s,
                                                 interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_qmatmul_static_matches_pallas(shape):
    m, k, n = shape
    xj, xt = _bf16_with_half_quotients(m, k, seed=m * k)
    w_i8, w_s, tw_i8, tw_s = _weights(k, n, seed=n + 1)
    for a_scale in (1.0, float(np.abs(np.asarray(xj, np.float32)).max()
                               / 127.0)):
        # a_scale 1.0 puts every k + 0.5 activation on a rounding boundary
        codes = t_ref.quantize_static_ref(xt, a_scale)
        inv = 1.0 / jnp.float32(a_scale)
        want_codes = jnp.clip(jnp.round(xj.astype(jnp.float32) * inv),
                              -127, 127).astype(jnp.int8)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
        got = qmatmul.qmatmul_static(xt, tw_i8, tw_s,
                                     torch.tensor(a_scale)).numpy()
        want = np.asarray(j_qmatmul.qmatmul_static(
            xj, w_i8, w_s, jnp.float32(a_scale), interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# G in {1, 2, 4}, hd in {32, 64}, dv != hd, S in {1, 77, 128}
FLASH_CASES = [
    # (hq, hkv, hd, dv, s)
    (2, 2, 32, 32, 1),
    (4, 2, 64, 64, 77),
    (4, 1, 32, 32, 128),
    (2, 2, 64, 48, 77),
    (4, 4, 32, 16, 128),
    (8, 2, 64, 64, 1),
]


@pytest.mark.parametrize("hq,hkv,hd,dv,s", FLASH_CASES)
def test_flash_prefill_matches_pallas(hq, hkv, hd, dv, s):
    rng = np.random.default_rng(hq * 1000 + hd + s)
    q = rng.normal(size=(1, s, hq, hd)).astype(np.float32)
    k = rng.normal(size=(1, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(1, s, hkv, dv)).astype(np.float32)
    want = np.asarray(flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = flash_prefill.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v)).numpy()
    assert got.shape == (1, s, hq, dv) and got.dtype == np.float32
    # f32 both sides; tiled online softmax vs one full-row softmax differ
    # only in summation order (~1e-7 relative)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_cpu_wrappers_count_no_launch():
    x = torch.randn(3, 64, dtype=torch.float32)
    w = torch.randint(-127, 128, (64, 16), dtype=torch.int8)
    s = torch.rand(1, 16)
    before = (dynquant.qmatmul_dynamic.launches,
              qmatmul.qmatmul_static.launches, flash_prefill.flash_prefill.launches)
    ops.qmatmul_dynamic(x, w, s)
    ops.qmatmul_static(x, w, torch.rand(1, 1), torch.tensor(0.05))
    q = torch.randn(1, 5, 2, 8)
    ops.flash_prefill(q, q, q)
    assert (dynquant.qmatmul_dynamic.launches, qmatmul.qmatmul_static.launches,
            flash_prefill.flash_prefill.launches) == before


def test_ops_broadcasts_per_tensor_scale():
    x = torch.randn(3, 64)
    w = torch.randint(-127, 128, (64, 16), dtype=torch.int8)
    y1 = ops.qmatmul_dynamic(x, w, torch.full((1, 1), 0.01))
    y2 = ops.qmatmul_dynamic(x, w, torch.full((1, 16), 0.01))
    assert torch.equal(y1, y2)


def test_wrappers_reject_bad_operands():
    x = torch.randn(4, 32)
    w = torch.randint(-127, 128, (32, 8), dtype=torch.int8)
    s = torch.rand(1, 8)
    with pytest.raises(TypeError):
        dynquant.qmatmul_dynamic(x.half(), w, s)
    with pytest.raises(ValueError):
        dynquant.qmatmul_dynamic(x.t().contiguous().t(), w, s)
    with pytest.raises(ValueError):
        qmatmul.qmatmul_static(torch.randn(4, 31), w, s, 0.1)
    q = torch.randn(1, 4, 2, 160)
    with pytest.raises(ValueError):
        flash_prefill.flash_prefill(q, q, q)          # hd > 128
    q = torch.randn(1, 4, 3, 8)
    with pytest.raises(ValueError):
        flash_prefill.flash_prefill(q, torch.randn(1, 4, 2, 8),
                                    torch.randn(1, 4, 2, 8))   # 3 % 2 != 0
