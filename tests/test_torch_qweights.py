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
kernel and oracle scales at rtol 1e-6 for this reason)."""
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
    before = t_quantize.quantize_weights.launches
    with pytest.raises(ValueError, match=r"\[K, N\]"):
        ops.quantize_weights(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.quantize_weights(torch.zeros(4, 4, dtype=torch.float16))
    with pytest.raises(ValueError, match="no quantize_weights kernel"):
        ops.quantize_weights(torch.zeros(4, 4, device="meta"))
    # the plain version counts no launch
    ops.quantize_weights(torch.ones(4, 4))
    assert t_quantize.quantize_weights.launches == before
