"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have no
CPU mode). This file imports no JAX, so it runs on a GPU host as is:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import dynquant, flash_prefill, qmatmul  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# M=1 (decode), N not a multiple of 8 (byte-wise weight path), K not a
# multiple of 64 (zero code tail), and a few-tile output (split-K)
@pytest.mark.parametrize("m,k,n", [(1, 2048, 2048), (37, 300, 203),
                                   (130, 257, 129), (256, 640, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qmatmul_kernels_match_plain(dev, m, k, n, dtype):
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(dtype)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((1, n), generator=gen, device=dev) * 1e-2
    codes, a_scale = qmatmul.quantize_activations(x)
    want_codes, want_scale = ref.quantize_rows_ref(x)
    assert torch.equal(codes, want_codes) and torch.equal(a_scale, want_scale)
    before = dynquant.qmatmul_dynamic.launches
    got = dynquant.qmatmul_dynamic(x, w, s)
    assert dynquant.qmatmul_dynamic.launches == before + 1
    # exact int32 sums and the same epilogue order on both sides
    torch.testing.assert_close(got, ref.qmatmul_dynamic_ref(x, w, s),
                               rtol=1e-6, atol=0)
    act = x.float().abs().amax() / 127.0
    codes, _ = qmatmul.quantize_activations(x, act)
    assert torch.equal(codes, ref.quantize_static_ref(x, act))
    torch.testing.assert_close(qmatmul.qmatmul_static(x, w, s, act),
                               ref.qmatmul_static_ref(x, w, s, act),
                               rtol=1e-6, atol=0)


def test_quantize_rounds_half_to_even(dev):
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0]],
                     device=dev)
    codes, _ = qmatmul.quantize_activations(x, torch.tensor(1.0))
    assert codes.tolist() == [[0, 2, 2, 0, -2, -2, 126, -127]]


@pytest.mark.parametrize("b,s,hq,hkv,hd,dv", [(1, 1, 4, 4, 64, 64),
                                              (2, 77, 8, 2, 64, 48),
                                              (1, 300, 32, 8, 128, 128),
                                              (2, 65, 6, 2, 32, 96)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_prefill_kernel_matches_plain(dev, b, s, hq, hkv, hd, dv, dtype):
    gen = torch.Generator(device=dev).manual_seed(s * hd + dv)
    q = torch.randn((b, s, hq, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, dv), generator=gen, device=dev).to(dtype)
    got = flash_prefill.flash_prefill(q, k, v)
    assert got.dtype == torch.float32 and got.shape == (b, s, hq, dv)
    # f32 on both sides (bf16 inputs are read as f32); summation order differs
    torch.testing.assert_close(got, ref.flash_prefill_ref(q, k, v),
                               rtol=0, atol=1e-4)
