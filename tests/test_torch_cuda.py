"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have no
CPU mode). This file imports no JAX, so it runs on a GPU host as is:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import math
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import (dynquant, flash_prefill,  # noqa: E402
                                 paged_attn, qdecode, qmatmul)
from repro_torch.kernels import autotune, quantize, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# Ragged shapes: M=1 (decode), N not a multiple of 8 (odd last column
# pair), K not a multiple of 128 (zero code tail); then the models' own:
# M across the decode body (1-16), the switch (17) and the wgmma tiles
# (64, 255, 1023, and 4632 = the VQI forward's 8 x 579 rows) at
# stablelm-1.6b's and phi-3-vision's weight shapes (K, N)
GEMM_M = (1, 4, 8, 16, 17, 64, 255, 1023, 4632)
GEMM_KN = ((2048, 2048), (2048, 11264), (5632, 2048), (2048, 100352),
           (3072, 3072), (3072, 16384), (8192, 3072), (1024, 3072),
           (3072, 32064))
GEMM_CASES = [(1, 2048, 2048), (37, 300, 203), (130, 257, 129),
              (256, 640, 1024), (5, 300, 203), (16, 257, 129)] + [
    (m, k, n) for k, n in GEMM_KN for m in GEMM_M]


@pytest.mark.parametrize("m,k,n", GEMM_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qmatmul_kernels_match_plain(dev, m, k, n, dtype):
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(dtype)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((1, n), generator=gen, device=dev) * 1e-2
    wp = qmatmul.pack_weight(w)
    body = qmatmul.plan(m, n, k).body
    codes, a_scale = qmatmul.quantize_activations(x)
    want_codes, want_scale = ref.quantize_rows_ref(x)
    assert torch.equal(codes, want_codes) and torch.equal(a_scale, want_scale)
    before = dict(dynquant.qmatmul_dynamic.launches_by_body)
    n_before = dynquant.qmatmul_dynamic.launches
    got = dynquant.qmatmul_dynamic_packed(x, wp, s)
    assert dynquant.qmatmul_dynamic.launches == n_before + 1
    assert dynquant.qmatmul_dynamic.launches_by_body == {
        **before, body: before[body] + 1}
    # exact int32 sums and the same epilogue order on both sides
    want = ref.qmatmul_dynamic_ref(x, w, s)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    # the [K, N] entry point packs and launches the same kernel; bf16 out
    # is the f32 result rounded once
    assert torch.equal(dynquant.qmatmul_dynamic(x, w, s), got)
    assert torch.equal(dynquant.qmatmul_dynamic_packed(
        x, wp, s, out_dtype=torch.bfloat16), got.to(torch.bfloat16))
    act = x.float().abs().amax() / 127.0
    codes, _ = qmatmul.quantize_activations(x, act)
    assert torch.equal(codes, ref.quantize_static_ref(x, act))
    before = dict(qmatmul.qmatmul_static.launches_by_body)
    got = qmatmul.qmatmul_static_packed(x, wp, s, act)
    assert qmatmul.qmatmul_static.launches_by_body == {
        **before, body: before[body] + 1}
    torch.testing.assert_close(got, ref.qmatmul_static_ref(x, w, s, act),
                               rtol=1e-6, atol=0)
    assert torch.equal(qmatmul.qmatmul_static(x, w, s, act), got)
    assert torch.equal(qmatmul.qmatmul_static_packed(
        x, wp, s, act, out_dtype=torch.bfloat16), got.to(torch.bfloat16))


def test_quantize_rounds_half_to_even(dev):
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0]],
                     device=dev)
    codes, _ = qmatmul.quantize_activations(x, torch.tensor(1.0))
    assert codes.tolist() == [[0, 2, 2, 0, -2, -2, 126, -127]]


# S 1, 63, 64, 65 and 579 around the 64-row / 64-key tiles; G 3, 4 and 5
# (G 3 and 5: a 64-row block and a 16-row warp tile straddle two
# positions' groups); hd 32..128 with dv 48; hd 40 (zero-padded to 48);
# rows that are no whole number of 16-byte chunks (hd 36 and dv 20 in
# bf16, hd 33 and dv 17 in both dtypes: staged element by element, dv 17
# stored column by column)
FLASH_CASES = [(1, 1, 4, 4, 64, 64),
               (2, 77, 8, 2, 64, 48),
               (1, 300, 32, 8, 128, 128),
               (2, 65, 6, 2, 32, 96),
               # phi-3-vision's VQI forward: 576 patches + 3 tokens
               (8, 579, 32, 32, 96, 96),
               (1, 63, 4, 4, 64, 64),
               (1, 64, 4, 4, 64, 64),
               (1, 65, 4, 4, 64, 64),
               (2, 579, 8, 2, 64, 64),
               (1, 100, 16, 4, 64, 64),
               (1, 70, 10, 2, 32, 32),
               (1, 130, 4, 2, 32, 48),
               (1, 130, 4, 2, 96, 48),
               (1, 130, 4, 2, 128, 48),
               (1, 90, 4, 4, 40, 40),
               (1, 90, 4, 2, 40, 48),
               (1, 70, 4, 2, 36, 20),
               (1, 50, 2, 1, 33, 17),
               # the MLA class <192, 128>: deepseek-v2's hd 192 / dv 128
               # at G 1 (f32 rows of 48 16-byte chunks), a ragged hd 150
               # and GQA at hd 160
               (1, 128, 4, 4, 192, 128),
               (2, 200, 8, 8, 192, 128),
               (1, 77, 4, 4, 150, 64),
               (1, 65, 8, 2, 160, 96)]


@pytest.mark.parametrize("b,s,hq,hkv,hd,dv", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_prefill_kernel_matches_plain(dev, b, s, hq, hkv, hd, dv, dtype):
    gen = torch.Generator(device=dev).manual_seed(s * hd + dv)
    q = torch.randn((b, s, hq, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, dv), generator=gen, device=dev).to(dtype)
    body = flash_prefill.body_for(q, k, v)
    before = dict(flash_prefill.flash_prefill.launches_by_body)
    got = flash_prefill.flash_prefill(q, k, v)
    after = flash_prefill.flash_prefill.launches_by_body
    assert after == {**before, body: before[body] + 1}
    assert got.dtype == torch.float32 and got.shape == (b, s, hq, dv)
    # f32 reference on the same values. The tensor-core body's bf16
    # products are exact in f32 and p is split into two bf16 terms (bf16:
    # ~1e-5); f32 operands are split too, three products per mma (~2e-5);
    # summation order differs
    torch.testing.assert_close(got, ref.flash_prefill_ref(q, k, v),
                               rtol=0, atol=1e-4)


# the bf16 MLA class on its wgmma body: one key, a prompt of 1000 (eight
# tiles, the last ragged), two sequences, GQA at hd 136, deepseek-v2's 128
# heads at 1024 (chip_smoke.py's MLA_FLASH)
MLA_CASES = [(1, 1, 4, 4, 192, 128),
             (1, 1000, 4, 4, 192, 128),
             (2, 300, 8, 8, 192, 128),
             (2, 129, 6, 2, 136, 64),
             (1, 1024, 128, 128, 192, 128)]


@pytest.mark.parametrize("b,s,hq,hkv,hd,dv", MLA_CASES)
def test_flash_prefill_mla_body(dev, b, s, hq, hkv, hd, dv):
    """Every bf16 prefill of the class that TMA can read takes the wgmma
    body (``MLA_BODY``), within 1e-4 of the f32 reference, and a second
    call gives the same bits (no atomics)."""
    gen = torch.Generator(device=dev).manual_seed(s + hd + dv + b)
    q = torch.randn((b, s, hq, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, hkv, dv), generator=gen, device=dev).bfloat16()
    assert flash_prefill.body_for(q, k, v) == flash_prefill.MLA_BODY
    before = dict(flash_prefill.flash_prefill.launches_by_body)
    got = flash_prefill.flash_prefill(q, k, v)
    assert flash_prefill.flash_prefill.launches_by_body == {
        **before, "tc_mla": before["tc_mla"] + 1}
    torch.testing.assert_close(got, ref.flash_prefill_ref(q, k, v), rtol=0,
                               atol=1e-4)
    assert torch.equal(flash_prefill.flash_prefill(q, k, v), got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_prefill_mla_class_refuses_wider_rows(dev, dtype):
    """hd 192 / dv 128 launches; dv 129 or hd 193 is refused by the
    wrapper, and the card entry point refuses what the wrapper would."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k = (torch.randn((1, 64, 2, 192), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    v = torch.randn((1, 64, 2, 128), generator=gen, device=dev).to(dtype)
    torch.testing.assert_close(flash_prefill.flash_prefill(q, k, v),
                               ref.flash_prefill_ref(q, k, v), rtol=0,
                               atol=1e-4)
    for hd, dv in ((193, 128), (192, 129)):
        q = torch.zeros((1, 8, 2, hd), device=dev, dtype=dtype)
        v = torch.zeros((1, 8, 2, dv), device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="hd="):
            flash_prefill.flash_prefill(q, q.clone(), v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_prefill_kernel_reads_unaligned_rows(dev, dtype):
    """Contiguous views that start 2 or 4 bytes into their storage: the
    16-byte copies cannot take them, so the body stages them element by
    element."""
    b, s, hq, hkv, hd, dv = 1, 77, 4, 2, 64, 64
    gen = torch.Generator(device=dev).manual_seed(7)

    def view(*shape):
        flat = torch.randn(math.prod(shape) + 1, generator=gen, device=dev)
        return flat.to(dtype)[1:].view(shape)

    q, k, v = view(b, s, hq, hd), view(b, s, hkv, hd), view(b, s, hkv, dv)
    assert q.is_contiguous() and q.data_ptr() % 16
    got = flash_prefill.flash_prefill(q, k, v)
    torch.testing.assert_close(got, ref.flash_prefill_ref(q, k, v),
                               rtol=0, atol=1e-4)


def _paged_case(dev, b, hkv, g, hd, bs, m, n, dtype, pos, seed, holes=()):
    """Random q and pools; each live sequence (pos >= 0) gets shuffled block
    ids for the entries its position reaches and -1 past its end; an idle
    row (pos < 0) gets an all -1 table at position 0, as an idle engine
    slot has; ``holes`` are (row, entry) pairs set to -1."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, hkv, g, hd), generator=gen).to(dtype)
    k_pool = torch.randn((n, bs, hkv, hd), generator=gen).to(dtype)
    v_pool = torch.randn((n, bs, hkv, hd), generator=gen).to(dtype)
    ids = (torch.randperm(n - 1, generator=gen) + 1).tolist()
    tables = torch.full((b, m), -1, dtype=torch.int32)
    for i, p in enumerate(pos):
        for j in range(p // bs + 1 if p >= 0 else 0):
            tables[i, j] = ids.pop()
    for i, j in holes:
        tables[i, j] = -1
    pos_t = torch.tensor([max(p, 0) for p in pos], dtype=torch.int32)
    return tuple(t.to(dev) for t in (q, k_pool, v_pool, tables, pos_t))


def _positions(b, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(36, 512, (b,), generator=gen).tolist()


# (b, hkv, g, hd, bs, m, n, pos): stablelm-1.6b engine shape; mistral-nemo
# width; one sequence at the last slot; small blocks; an idle row; then
# the split-K edges of the int8 kernel: blocks of 1 slot (a 600-entry
# table) and of 32, positions one before, at and after a share boundary
# (n_keys 64, 65, 66, 256, 257, 258: shares of 32 and 64 slots at 8
# splits), G 8 at hd 128 and phi-3-vision's hd 96 with an idle row; then
# the fp pools' lane plan: G 8 at hd 128 over blocks of one slot (16 lanes
# a row), and hd 40 and 8, whose rows leave lanes masked
PAGED_CASES = {
    "stablelm": (8, 32, 1, 64, 16, 32, 257, _positions(8, 0)),
    "nemo": (8, 8, 4, 128, 16, 32, 257, _positions(8, 1)),
    "b1": (1, 32, 1, 64, 16, 32, 33, [511]),
    "bs8": (3, 4, 8, 32, 8, 8, 25, [63, 7, 30]),
    "idle": (4, 8, 2, 64, 32, 4, 17, [100, -1, 31, 127]),
    "bs1": (2, 4, 1, 64, 1, 600, 1300, [599, 40]),
    "bs32": (3, 8, 2, 64, 32, 16, 60, [511, 32, 31]),
    "share_edges": (6, 4, 1, 64, 16, 32, 120, [63, 64, 65, 255, 256, 257]),
    "g8": (2, 4, 8, 128, 16, 32, 70, [300, 511]),
    "hd96": (4, 8, 1, 96, 16, 40, 170, [578, 100, -1, 33]),
    "g8_bs1": (2, 4, 8, 128, 1, 300, 700, [299, 150]),
    "hd40": (3, 4, 4, 40, 8, 8, 30, [63, -1, 20]),
    "hd8": (2, 2, 2, 8, 4, 16, 40, [63, 0]),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_kernel_matches_plain(dev, case, dtype):
    b, hkv, g, hd, bs, m, n, pos = PAGED_CASES[case]
    q, k_pool, v_pool, tables, pos_t = _paged_case(
        dev, b, hkv, g, hd, bs, m, n, dtype, pos, seed=b * hd + bs,
        holes=[(0, 1)] if case == "idle" else ())
    before = paged_attn.paged_decode.launches
    got = paged_attn.paged_decode(q, k_pool, v_pool, tables, pos_t)
    assert paged_attn.paged_decode.launches == before + 1
    want = ref.paged_decode_ref(q, k_pool, v_pool, tables, pos_t)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    idle = torch.tensor([p < 0 for p in pos], device=dev)
    # an idle row is 0/0 on both sides and nothing else is
    assert torch.equal(got.isnan().all(-1).all(-1).all(-1), idle)
    assert torch.equal(want.isnan().all(-1).all(-1).all(-1), idle)
    # f32 on both sides (bf16 read as f32); summation order differs
    torch.testing.assert_close(got[~idle], want[~idle], rtol=0, atol=1e-4)
    # one launch, no atomics: a second call gives the same bits
    twice = paged_attn.paged_decode(q, k_pool, v_pool, tables, pos_t)
    assert torch.equal(twice[~idle], got[~idle])
    assert torch.equal(twice.isnan(), got.isnan())
    # masked slots are never read: NaN in the trash block changes nothing
    k_pool[0], v_pool[0] = float("nan"), float("nan")
    again = paged_attn.paged_decode(q, k_pool, v_pool, tables, pos_t)
    assert torch.equal(again[~idle], got[~idle])
    assert torch.isfinite(again[~idle]).all()


# ------------------------------------------------------------------ #
# The int8-KV kernels
# ------------------------------------------------------------------ #
def _codes(gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)


def _scales(gen, shape):
    # positive scales: dequantized values of order 1, as quantized K/V are
    return (torch.rand(shape, generator=gen) + 0.5) / 127


# (b, s, hkv, g, hd, positions or None: drawn): the stablelm-1.6b
# dense-engine shape; mistral-nemo width with a ragged S; then the split-K
# edges: B1 S512 (8 splits), S one before, at and after a share boundary
# (8, 8 and 9 tiles at 8 splits), G 8 at hd 128 and phi-3-vision's hd 96;
# a row whose every slot is masked (averaged uniformly, as the plain
# softmax does)
QDECODE_CASES = {
    "stablelm": (8, 512, 32, 1, 64, None),
    "nemo": (3, 77, 8, 4, 128, None),
    "b1": (1, 512, 32, 1, 64, [511]),
    "share_255": (2, 255, 4, 1, 64, [254, 31]),
    "share_256": (2, 256, 4, 4, 64, [255, 32]),
    "share_257": (2, 257, 4, 1, 64, [256, 0]),
    "g8": (2, 300, 4, 8, 128, None),
    "hd96": (4, 579, 8, 1, 96, None),
    "masked_row": (3, 300, 2, 4, 64, [-1, 150, 299]),
}


@pytest.mark.parametrize("case", sorted(QDECODE_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qdecode_kernel_matches_plain(dev, case, dtype):
    b, s, hkv, g, hd, pos = QDECODE_CASES[case]
    gen = torch.Generator().manual_seed(s + hd)
    q = torch.randn((b, hkv, g, hd), generator=gen).to(dtype)
    pos = (torch.randint(0, s, (b,), generator=gen) if pos is None
           else torch.tensor(pos))
    bias = torch.where(torch.arange(s)[None] <= pos[:, None],
                       torch.tensor(0.0), torch.tensor(-2.0e38))
    args = tuple(t.to(dev) for t in (
        q, _codes(gen, (b, s, hkv, hd)), _scales(gen, (b, s, hkv)),
        _codes(gen, (b, s, hkv, hd)), _scales(gen, (b, s, hkv)), bias))
    before = qdecode.qdecode.launches
    got = qdecode.qdecode(*args)
    assert qdecode.qdecode.launches == before + 1
    want = ref.qdecode_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    # f32 both sides: the kernel scales after the dot, the plain version
    # dequantizes first; summation order differs
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    # one launch, no atomics: a second call gives the same bits
    assert torch.equal(qdecode.qdecode(*args), got)
    assert qdecode.qdecode.launches == before + 2


# the wide class: recurrentgemma's 16 x 256 over one kv head at its
# engine's ring (S 2048), G 16 at hd 128 and G 12 at hd 192 (a partial
# second head group, lanes past hd masked), G 8 at hd 256 (one group)
WIDE_CASES = {
    "rgemma": (8, 2048, 1, 16, 256),
    "g16_hd128": (2, 300, 2, 16, 128),
    "g12_hd192": (3, 257, 1, 12, 192),
    "g8_hd256": (2, 64, 2, 8, 256),
}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qdecode_wide_class_matches_plain(dev, case, dtype):
    """The wide class against ``qdecode_ref``: a ring's masked slots (the
    bias), a row whose masked slot holds a NaN v scale (NaN in both, as
    the plain version reads every slot of a dense cache), and a row whose
    every slot is masked (a uniform average in both, as the plain softmax
    gives); the other rows finite and close."""
    b, s, hkv, g, hd = WIDE_CASES[case]
    assert qdecode.wide_class(g, hd)
    gen = torch.Generator().manual_seed(s + hd + g)
    q = torch.randn((b, hkv, g, hd), generator=gen).to(dtype)
    pos = torch.randint(0, s, (b,), generator=gen)
    # a ring: a window of valid slots that wraps past the end
    start = torch.randint(0, s, (b,), generator=gen)
    slot = torch.arange(s)[None]
    valid = ((slot - start[:, None]) % s) <= pos[:, None]
    valid[-1] = False                             # fully masked row
    bias = torch.where(valid, torch.tensor(0.0), torch.tensor(-2.0e38))
    vs = _scales(gen, (b, s, hkv))
    poison = b > 2
    if poison:
        masked = int(torch.nonzero(~valid[1])[0, 0]) if (~valid[1]).any() \
            else None
        if masked is not None:
            vs[1, masked] = float("nan")
    args = tuple(t.to(dev) for t in (
        q, _codes(gen, (b, s, hkv, hd)), _scales(gen, (b, s, hkv)),
        _codes(gen, (b, s, hkv, hd)), vs, bias))
    before = dict(qdecode.qdecode.launches_by_class)
    got = qdecode.qdecode(*args)
    assert qdecode.qdecode.launches_by_class == {
        **before, "wide": before["wide"] + 1}
    want = ref.qdecode_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.isfinite(want[-1]).all()
    assert torch.equal(got.isnan(), want.isnan())
    live = ~want.isnan().any(dim=(1, 2, 3))
    assert live.sum() >= 2 and live[-1] and torch.isfinite(got[live]).all()
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-4)
    assert torch.equal(qdecode.qdecode(*args).nan_to_num(), got.nan_to_num())


def _to_int8_pools(gen, k_pool, v_pool):
    n, bs, hkv, _ = k_pool.shape
    return (_codes(gen, k_pool.shape).to(k_pool.device),
            _scales(gen, (n, bs, hkv)).to(k_pool.device),
            _codes(gen, v_pool.shape).to(k_pool.device),
            _scales(gen, (n, bs, hkv)).to(k_pool.device))


@pytest.mark.parametrize("case", ["stablelm", "nemo", "idle", "b1", "bs1",
                                  "bs32", "share_edges", "g8", "hd96"])
def test_paged_qdecode_kernel_matches_plain(dev, case):
    b, hkv, g, hd, bs, m, n, pos = PAGED_CASES[case]
    q, k_pool, v_pool, tables, pos_t = _paged_case(
        dev, b, hkv, g, hd, bs, m, n, torch.bfloat16, pos, seed=b * hd + bs,
        holes=[(0, 1)] if case in ("idle", "bs1", "hd96") else ())
    pools = _to_int8_pools(torch.Generator().manual_seed(hd), k_pool, v_pool)
    before = paged_attn.paged_qdecode.launches
    got = paged_attn.paged_qdecode(q, *pools, tables, pos_t)
    assert paged_attn.paged_qdecode.launches == before + 1
    want = ref.paged_qdecode_ref(q, *pools, tables, pos_t)
    torch.cuda.synchronize()
    idle = torch.tensor([p < 0 for p in pos], device=dev)
    assert torch.equal(got.isnan().all(-1).all(-1).all(-1), idle)
    assert torch.equal(want.isnan().all(-1).all(-1).all(-1), idle)
    torch.testing.assert_close(got[~idle], want[~idle], rtol=0, atol=1e-4)
    # one launch, no atomics: a second call gives the same bits
    twice = paged_attn.paged_qdecode(q, *pools, tables, pos_t)
    assert paged_attn.paged_qdecode.launches == before + 2
    assert torch.equal(twice[~idle], got[~idle])
    assert torch.equal(twice.isnan(), got.isnan())
    # what an idle slot writes into the trash block (NaN scales, any
    # codes) is never read: the live rows do not change
    k_q, k_s, v_q, v_s = pools
    k_q[0], v_q[0] = -128, -128
    k_s[0], v_s[0] = float("nan"), float("nan")
    again = paged_attn.paged_qdecode(q, *pools, tables, pos_t)
    assert torch.equal(again[~idle], got[~idle])
    assert torch.isfinite(again[~idle]).all()


# chip_smoke.py's flash shapes (hd 64 G 1, hd 128 G 4, hd 128 / dv 64, the
# VQI's hd 96 over S 579), then ragged ones: S not a multiple of the 64-key
# tile, hd and dv not multiples of 16 (the zero-padded path), dv 48
@pytest.mark.parametrize("b,s,hq,hkv,hd,dv", [(4, 256, 32, 32, 64, 64),
                                              (2, 77, 8, 2, 64, 48),
                                              (1, 300, 32, 8, 128, 128),
                                              (2, 200, 16, 16, 128, 64),
                                              (2, 579, 8, 8, 96, 96),
                                              (1, 130, 4, 2, 40, 24),
                                              (1, 65, 6, 2, 32, 96)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_qprefill_kernel_matches_plain(dev, b, s, hq, hkv, hd, dv,
                                             dtype):
    gen = torch.Generator().manual_seed(s * hd + dv)
    args = tuple(t.to(dev) for t in (
        torch.randn((b, s, hq, hd), generator=gen).to(dtype),
        _codes(gen, (b, s, hkv, hd)), _scales(gen, (b, s, hkv)),
        _codes(gen, (b, s, hkv, dv)), _scales(gen, (b, s, hkv))))
    body = flash_prefill.QBODY[dtype]
    before = dict(flash_prefill.flash_qprefill.launches_by_body)
    n_before = flash_prefill.flash_qprefill.launches
    got = flash_prefill.flash_qprefill(*args)
    assert flash_prefill.flash_qprefill.launches == n_before + 1
    assert flash_prefill.flash_qprefill.launches_by_body == {
        **before, body: before[body] + 1}
    assert got.dtype == torch.float32 and got.shape == (b, s, hq, dv)
    # f32 reference on the dequantized values: the codes are exact in bf16,
    # p * v_s is split in two bf16 terms and f32 q in two (~1e-5); the
    # kernel scales after the dot, the plain version dequantizes first
    torch.testing.assert_close(got, ref.flash_qprefill_ref(*args), rtol=0,
                               atol=1e-4)
    # one launch, no atomics: a second call gives the same bits
    assert torch.equal(flash_prefill.flash_qprefill(*args), got)


# ------------------------------------------------------------------ #
# The int4-KV kernels and quantizer
# ------------------------------------------------------------------ #
def _packed(gen, shape):
    # every byte, so every nibble -8..7 (the wire layout, not only +-7)
    return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)


def _gscales(gen, shape):
    # f16 group scales of dequantized values of order 1, as int4 K/V are
    return ((torch.rand(shape, generator=gen) + 0.5) / 7).to(torch.float16)


def _to_int4_pools(gen, k_pool, v_pool):
    n, bs, hkv, hd = k_pool.shape
    dev = k_pool.device
    return (_packed(gen, (n, bs, hkv, hd // 2)).to(dev),
            _gscales(gen, (n, bs, hkv, hd // 32)).to(dev),
            _packed(gen, (n, bs, hkv, hd // 2)).to(dev),
            _gscales(gen, (n, bs, hkv, hd // 32)).to(dev))


# every PAGED_CASES kind but bs8 (hd 32: one group, two lanes a row at G
# bound 8, covered by the "hd32" case): the split loop's edges in int4
@pytest.mark.parametrize("case", ["stablelm", "nemo", "idle", "b1", "bs1",
                                  "bs32", "share_edges", "g8", "hd96",
                                  "hd32"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_q4decode_kernel_matches_plain(dev, case, dtype):
    b, hkv, g, hd, bs, m, n, pos = {
        **PAGED_CASES, "hd32": (3, 4, 4, 32, 8, 8, 25, [63, 7, 30])}[case]
    q, k_pool, v_pool, tables, pos_t = _paged_case(
        dev, b, hkv, g, hd, bs, m, n, dtype, pos, seed=b * hd + bs,
        holes=[(0, 1)] if case in ("idle", "bs1", "hd96") else ())
    pools = _to_int4_pools(torch.Generator().manual_seed(hd + 4), k_pool,
                           v_pool)
    before = paged_attn.paged_q4decode.launches
    got = paged_attn.paged_q4decode(q, *pools, tables, pos_t)
    assert paged_attn.paged_q4decode.launches == before + 1
    want = ref.paged_q4decode_ref(q, *pools, tables, pos_t)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    idle = torch.tensor([p < 0 for p in pos], device=dev)
    assert torch.equal(got.isnan().all(-1).all(-1).all(-1), idle)
    assert torch.equal(want.isnan().all(-1).all(-1).all(-1), idle)
    # f32 both sides, both dequantize before the dot; summation order
    # differs
    torch.testing.assert_close(got[~idle], want[~idle], rtol=0, atol=1e-4)
    # one launch, no atomics: a second call gives the same bits
    twice = paged_attn.paged_q4decode(q, *pools, tables, pos_t)
    assert torch.equal(twice[~idle], got[~idle])
    assert torch.equal(twice.isnan(), got.isnan())
    # what an idle slot writes into the trash block (NaN f16 scales, any
    # bytes: 0x88 here) is never read: the live rows do not change
    k_q, k_s, v_q, v_s = pools
    k_q[0], v_q[0] = -120, -120
    k_s[0], v_s[0] = float("nan"), float("nan")
    again = paged_attn.paged_q4decode(q, *pools, tables, pos_t)
    assert torch.equal(again[~idle], got[~idle])
    assert torch.isfinite(again[~idle]).all()


# chip_smoke.py's flash shapes (dv a multiple of the group of 32), then
# hd 32 with dv 96 (one K scale a key: 2 bytes) and G 4 at S 65
@pytest.mark.parametrize("b,s,hq,hkv,hd,dv", [(4, 256, 32, 32, 64, 64),
                                              (2, 300, 32, 8, 128, 128),
                                              (2, 200, 16, 16, 128, 64),
                                              (1, 64, 32, 32, 64, 64),
                                              (2, 579, 32, 32, 96, 96),
                                              (1, 65, 8, 2, 32, 96)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_q4prefill_kernel_matches_plain(dev, b, s, hq, hkv, hd, dv,
                                              dtype):
    gen = torch.Generator().manual_seed(s * hd + dv + 4)
    args = tuple(t.to(dev) for t in (
        torch.randn((b, s, hq, hd), generator=gen).to(dtype),
        _packed(gen, (b, s, hkv, hd // 2)),
        _gscales(gen, (b, s, hkv, hd // 32)),
        _packed(gen, (b, s, hkv, dv // 2)),
        _gscales(gen, (b, s, hkv, dv // 32))))
    before = flash_prefill.flash_q4prefill.launches
    bodies = dict(flash_prefill.flash_q4prefill.launches_by_body)
    got = flash_prefill.flash_q4prefill(*args)
    assert flash_prefill.flash_q4prefill.launches == before + 1
    body = flash_prefill.Q4BODY[dtype]
    assert flash_prefill.flash_q4prefill.launches_by_body == {
        **bodies, body: bodies[body] + 1}
    assert got.dtype == torch.float32 and got.shape == (b, s, hq, dv)
    torch.testing.assert_close(got, ref.flash_q4prefill_ref(*args), rtol=0,
                               atol=1e-4)
    # one launch, no atomics: a second call gives the same bits
    assert torch.equal(flash_prefill.flash_q4prefill(*args), got)


# ------------------------------------------------------------------ #
# Every instantiated tile of the three flash bodies
# ------------------------------------------------------------------ #
# (kernel, hd): each width class of each body (the MLA class for
# flash_prefill: flash_mla's one tile in bf16, flash_tc's in f32); S short
# (one partial tile at any BK), a multiple of 64 and ragged; G 1 and 4
TILE_CASES = [(kernel, hd, s, g)
              for kernel, hds in (("flash_prefill", (64, 96, 128, 192)),
                                  ("flash_qprefill", (64, 96, 128)),
                                  ("flash_q4prefill", (64, 96, 128)))
              for hd in hds for s in (17, 128, 200) for g in (1, 4)]


@pytest.mark.parametrize("kernel,hd,s,g", TILE_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_instantiated_tile_matches_plain(dev, kernel, hd, s, g, dtype):
    """Each (block_q, block_k) the body instantiates at this width class
    (``autotune.tiles``) launches once, is counted under its tile and
    holds to the plain version at 1e-4 (the kernels' tolerance at the
    default tile)."""
    gen = torch.Generator().manual_seed(hd * 1000 + s * 10 + g)
    b, hkv = 1, 2
    dv = 128 if hd > 128 else hd
    q = torch.randn((b, s, hkv * g, hd), generator=gen).to(dtype).to(dev)
    if kernel == "flash_prefill":
        kv = [torch.randn((b, s, hkv, d), generator=gen).to(dtype).to(dev)
              for d in (hd, dv)]
        body = flash_prefill.body_for(q, *kv)
    elif kernel == "flash_qprefill":
        kv = [t.to(dev) for t in (
            _codes(gen, (b, s, hkv, hd)), _scales(gen, (b, s, hkv)),
            _codes(gen, (b, s, hkv, dv)), _scales(gen, (b, s, hkv)))]
        body = flash_prefill.QBODY[dtype]
    else:
        kv = [t.to(dev) for t in (
            _packed(gen, (b, s, hkv, hd // 2)),
            _gscales(gen, (b, s, hkv, hd // 32)),
            _packed(gen, (b, s, hkv, dv // 2)),
            _gscales(gen, (b, s, hkv, dv // 32)))]
        body = flash_prefill.Q4BODY[dtype]
    entry = getattr(flash_prefill, kernel)
    want = getattr(ref, f"{kernel}_ref")(q, *kv)
    tiles = autotune.tiles(body, autotune.width(hd, dv))
    assert autotune.DEFAULT_TILE in tiles or tiles == (autotune.MLA_TILE,)
    for bq, bk in tiles:
        before = dict(entry.launches_by_tile)
        got = entry(q, *kv, block_q=bq, block_k=bk)
        key = f"{body}:{bq}x{bk}"
        assert entry.launches_by_tile == {**before, key: before[key] + 1}
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4,
                                   msg=lambda m, t=(bq, bk): f"{t}: {m}")


def test_quantize_kv_int4_edge_rows_card_equals_cpu(dev):
    """Exact .5 quotients, an all-zero group (0/0 -> code 0: the cast of
    NaN is made explicit) and a group whose f16 scale underflows to 0
    (x/0 -> +-7): the card's codes and scales equal the CPU's."""
    gen = torch.Generator().manual_seed(5)
    t = torch.randn((2, 3, 2, 64), generator=gen) * 3
    halves = torch.tensor([7, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5,
                           4.5, -6.5, 6.5, 0, 1, -7, 5.5]).repeat(2)
    t[0, 0, 0, :32] = halves * 0.25
    t[0, 1, 1, :32] = 0
    t[1, 2, 0, :32] = torch.randn(32, generator=gen) * 1e-9
    for dtype in (torch.float32, torch.bfloat16):
        x = t.to(dtype)
        want_q, want_s = quantize.quantize_kv_int4(x)
        got_q, got_s = quantize.quantize_kv_int4(x.to(dev))
        assert torch.equal(got_q.cpu(), want_q)
        assert torch.equal(got_s.cpu(), want_s)
        codes = quantize.unpack_int4(got_q).cpu()
        assert (codes[0, 1, 1, :32] == 0).all()
        assert (codes[1, 2, 0, :32].abs() == 7).all()


def _qw_case(dev, k, n, dtype, aligned):
    """w [K, N] with an all-zero column and a column of exact .5 quotients,
    on the CPU and on the card; ``aligned=False`` offsets the card copy by
    one element (no 16-byte base: plain loads, or one-element loads)."""
    gen = torch.Generator().manual_seed(k + n)
    w = torch.randn((k, n), generator=gen) * 3
    w[:, 1] = 0.0
    w[:, 2] = torch.randint(-126, 126, (k,), generator=gen) + 0.5
    w[0, 2] = 127.0                       # inv = 1: every value a .5 code
    w = w.to(dtype)
    if aligned:
        return w, w.to(dev)
    buf = torch.empty(k * n + 1, dtype=dtype, device=dev)
    wd = buf[1:].view(k, n)
    wd.copy_(w)
    return w, wd


def _check_qw(w, wd):
    """One launch on the route of the plan, codes and scales bit for bit
    against the plain version on the CPU and on the card."""
    k, n = w.shape
    plan = quantize.plan_for(wd)
    before = quantize.quantize_weights.launches
    routes = dict(quantize.quantize_weights.routes)
    codes, scale = quantize.quantize_weights(wd)
    assert quantize.quantize_weights.launches == before + 1
    routes[plan.route] += 1
    assert quantize.quantize_weights.routes == routes
    torch.cuda.synchronize()
    want_codes, want_scale = ref.quantize_ref(w)
    assert codes.dtype == torch.int8 and scale.shape == (1, n)
    assert torch.equal(codes.cpu(), want_codes)
    assert torch.equal(scale.cpu().view(torch.int32),
                       want_scale.view(torch.int32))
    # and the plain version on the card gives the same bits
    card_codes, card_scale = ref.quantize_ref(wd)
    assert torch.equal(card_codes, codes)
    assert torch.equal(card_scale.view(torch.int32), scale.view(torch.int32))
    assert int(codes[:, 1].abs().max()) == 0
    halves = w[:, 2].to(torch.float32)    # round half to even
    assert torch.equal(codes[:, 2].cpu().to(torch.float32),
                       torch.round(halves))
    return plan


# the JAX package's test shapes (ragged N and K), a decode-width panel, and
# N with a 16-byte row pitch in each dtype
@pytest.mark.parametrize("k,n", [(64, 64), (300, 96), (1024, 512), (48, 33),
                                 (1024, 3072), (96, 40)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False])
def test_quantize_weights_kernel_matches_plain(dev, k, n, dtype, aligned):
    """Codes and scales bit for bit, an all-zero column and exact .5
    quotients included; ``aligned=False`` offsets the input by one element,
    which takes the plain-load fill."""
    _check_qw(*_qw_case(dev, k, n, dtype, aligned))


@pytest.mark.parametrize("c", list(range(1, quantize.CLUSTER_MAX + 1)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False])
def test_quantize_weights_every_cluster_size(dev, c, dtype, aligned):
    """Each cluster size the plan can return: K = 8 c - 3 rows (c boxes of
    8 rows, the last rank 5 of them) and N = 200 (six strips of 32 columns
    and a ragged one of 8)."""
    plan = _check_qw(*_qw_case(dev, 8 * c - 3, 200, dtype, aligned))
    assert (plan.route, plan.cluster) == ("cluster", c)
    assert plan.load == ("tma" if aligned else "plain")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False])
def test_quantize_weights_two_pass_route(dev, dtype, aligned):
    """A K taller than CLUSTER_MAX CTAs hold takes the two-pass route."""
    plan = _check_qw(*_qw_case(dev, 30000, 64, dtype, aligned))
    assert plan.route == "two_pass"
    assert plan.load == ("vec" if aligned else "scalar")


# ------------------------------------------------------------------ #
# Training: flash_prefill under autograd; no other wrapper drops a grad
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("b,s,hq,hkv,hd,dv", [(8, 128, 32, 32, 64, 64),
                                              (2, 100, 32, 8, 96, 96),
                                              (2, 77, 4, 2, 64, 32),
                                              (1, 130, 4, 4, 192, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_prefill_grads_through_the_kernel(dev, b, s, hq, hkv, hd, dv,
                                                dtype):
    """Under grad the wrapper launches the kernel through its autograd
    Function; (dq, dk, dv) match torch.autograd through the plain version
    on f32 copies of the same inputs within 1e-4 of each grad's largest
    element (f32), or one bf16 ulp of it (bf16: each grad is rounded to
    bf16 once, up to 2**-8 of itself)."""
    gen = torch.Generator(device=dev).manual_seed(s + hd + dv)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               .requires_grad_(True)
               for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                             (b, s, hkv, dv)))
    dout = torch.randn((b, s, hq, dv), generator=gen, device=dev)
    body = flash_prefill.body_for(q, k, v)
    before = dict(flash_prefill.flash_prefill.launches_by_body)
    out = flash_prefill.flash_prefill(q, k, v)
    assert out.grad_fn is not None
    assert flash_prefill.flash_prefill.launches_by_body == {
        **before, body: before[body] + 1}
    got = torch.autograd.grad(out, (q, k, v), dout)
    f32 = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_prefill_ref(*f32), f32, dout)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        torch.testing.assert_close(g.float(), w, rtol=0,
                                   atol=tol * w.abs().max().item())
    # without grad the same call returns a tensor with no graph
    with torch.no_grad():
        assert flash_prefill.flash_prefill(q, k, v).grad_fn is None


def _grad_cases(dev):
    """(name, call) for every kernel wrapper but flash_prefill, each
    called with a float input that requires grad."""
    gen = torch.Generator().manual_seed(0)
    f = lambda *shape: torch.randn(shape, generator=gen).to(dev)  # noqa: E731
    x = f(4, 64).requires_grad_(True)
    w = _codes(gen, (64, 48)).to(dev)
    ws = _scales(gen, (1, 48)).to(dev)
    wp = qmatmul.pack_weight(w)
    act = torch.tensor(0.05, device=dev)
    q = f(2, 4, 1, 64).requires_grad_(True)
    _, kp, vp, tables, pos = _paged_case(dev, 2, 4, 1, 64, 16, 4, 9,
                                         torch.float32, [40, 20], seed=1)
    k8, ks8, v8, vs8 = _to_int8_pools(gen, kp, vp)
    k4, ks4, v4, vs4 = _to_int4_pools(gen, kp, vp)
    dense = tuple(t.to(dev) for t in (
        _codes(gen, (2, 32, 4, 64)), _scales(gen, (2, 32, 4)),
        _codes(gen, (2, 32, 4, 64)), _scales(gen, (2, 32, 4))))
    bias = torch.zeros((2, 32), device=dev)
    qp = f(2, 32, 4, 64).requires_grad_(True)
    k4d = _packed(gen, (2, 32, 4, 32)).to(dev)
    s4d = _gscales(gen, (2, 32, 4, 2)).to(dev)
    return [
        ("qmatmul_dynamic", lambda: dynquant.qmatmul_dynamic(x, w, ws)),
        ("qmatmul_dynamic",
         lambda: dynquant.qmatmul_dynamic_packed(x, wp, ws)),
        ("qmatmul_static", lambda: qmatmul.qmatmul_static(x, w, ws, act)),
        ("qmatmul_static",
         lambda: qmatmul.qmatmul_static_packed(x, wp, ws, act)),
        ("quantize_activations", lambda: qmatmul.quantize_activations(x)),
        ("qdecode", lambda: qdecode.qdecode(q, *dense, bias)),
        ("paged_decode",
         lambda: paged_attn.paged_decode(q, kp, vp, tables, pos)),
        ("paged_qdecode", lambda: paged_attn.paged_qdecode(
            q, k8, ks8, v8, vs8, tables, pos)),
        ("paged_q4decode", lambda: paged_attn.paged_q4decode(
            q, k4, ks4, v4, vs4, tables, pos)),
        ("flash_qprefill",
         lambda: flash_prefill.flash_qprefill(qp, *dense)),
        ("flash_q4prefill",
         lambda: flash_prefill.flash_q4prefill(qp, k4d, s4d, k4d, s4d)),
        ("quantize_weights", lambda: quantize.quantize_weights(
            f(64, 48).requires_grad_(True))),
    ]


def test_kernel_wrappers_refuse_to_drop_a_gradient(dev):
    """Every wrapper without a backward raises, naming itself, when grad
    mode is on and an input requires grad; under no_grad it launches."""
    for name, call in _grad_cases(dev):
        with pytest.raises(RuntimeError, match=f"^{name}: .*no backward"):
            call()
        with torch.no_grad():
            out = call()
        assert all(t.grad_fn is None for t in
                   (out if isinstance(out, tuple) else (out,))
                   if isinstance(t, torch.Tensor))


def test_train_step_on_the_card_launches_flash_twice_a_layer(dev):
    """A train step of the stablelm smoke model (remat on) on the card:
    every attention layer launches the kernel in the forward and again in
    the recompute, and the step's loss and grad norm are finite."""
    from repro_torch import configs
    from repro_torch.data import lm_stream
    from repro_torch.models import init_params
    from repro_torch.training import OptimizerConfig, adamw_init, train_step

    cfg = configs.smoke_config("stablelm-1.6b").with_overrides(
        dtype="float32", remat=True)
    params = init_params(cfg, seed=0, device=dev)
    oc = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    state = adamw_init(params, oc)
    batch = next(lm_stream(cfg, 4, 32, device=dev))
    before = flash_prefill.flash_prefill.launches_by_body["tc_f32"]
    params, state, metrics = train_step(params, state, batch, cfg, oc)
    torch.cuda.synchronize()
    assert flash_prefill.flash_prefill.launches_by_body["tc_f32"] \
        == before + 2 * cfg.n_layers
    assert all(torch.isfinite(metrics[k]).item()
               for k in ("loss", "grad_norm"))


# --------------------------------------------------------------------- #
# Weight-only linears, the chunked prefill, the percentile, speculation
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("recipe", [
    dict(bits=4, group_size=64), dict(bits=8, group_size=128),
    dict(symmetric=False), dict(bits=4, clip_percentile=99.9)], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_weight_only_linear_card_equals_cpu(dev, recipe, dtype):
    """int4 / grouped / asymmetric leaves: codes and scales quantized on the
    card are the CPU's bit for bit, and the dequantize-then-matmul linear
    agrees with the CPU's to the dtype's matmul rounding."""
    from repro_torch.core.quant import quantize_tensor
    from repro_torch.models.layers import linear, place_params

    gen = torch.Generator().manual_seed(3)
    w = (torch.randn(2048, 512, generator=gen) * 0.05).to(dtype)
    x = torch.randn(5, 2048, generator=gen).to(dtype)
    kw = dict(recipe)
    kw["group_size"] = kw.get("group_size", 0)
    cpu = quantize_tensor(w, **kw)
    card = quantize_tensor(w.to(dev), **kw)
    for key in cpu:
        assert torch.equal(card[key].cpu(), cpu[key]), key
    leaf = place_params(card, dev)              # stays weight-only
    assert "w_packed" not in leaf
    want = linear(cpu, x.float()).float()
    got = linear(leaf, x.to(dev).float()).float().cpu()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)
    if dtype == torch.bfloat16:
        got16 = linear(leaf, x.to(dev)).float().cpu()
        assert (got16 - want).abs().max() <= 2 ** -6 * want.abs().max()


def test_percentile_on_a_2_25_leaf_card_equals_cpu(dev):
    """The sort + gather percentile on a 2^25-element leaf (per channel and
    per tensor, both over 2^24): the card's scales are the CPU's bit for
    bit (``torch.quantile`` refuses the leaf on either device)."""
    from repro_torch.core.quant import percentile, quantize_tensor

    w = torch.randn(8192, 4096, generator=torch.Generator().manual_seed(5))
    assert w.numel() == 2 ** 25
    for dims in ((0,), (0, 1)):
        assert torch.equal(percentile(w.abs().to(dev), 99.9, dims).cpu(),
                           percentile(w.abs(), 99.9, dims))
    for per_channel in (True, False):
        cpu = quantize_tensor(w, per_channel=per_channel,
                              clip_percentile=99.9)
        card = quantize_tensor(w.to(dev), per_channel=per_channel,
                               clip_percentile=99.9)
        for key in cpu:
            assert torch.equal(card[key].cpu(), cpu[key]), key


@pytest.mark.parametrize("tier", ["fp", "int8", "int4"])
def test_chunked_prefill_card_equals_cpu(dev, tier):
    """``opt_flash_prefill=False`` on the card (the chunked core, plain
    PyTorch) against the CPU: logits of a 600-token prefill (two query
    chunks) in f32 within 1e-3, and the quantized caches' codes equal but
    for rare .5 flips."""
    from repro_torch import configs
    from repro_torch.models import init_params, prefill
    from repro_torch.models.layers import place_params

    cfg = configs.smoke_config("mistral-nemo-12b").with_overrides(
        dtype="float32", opt_flash_prefill=False, kv_cache_precision=tier)
    params = init_params(cfg, seed=1, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 600),
                           generator=torch.Generator().manual_seed(2))
    launches = flash_prefill.flash_prefill.launches
    with torch.no_grad():
        want, cache = prefill(params, {"tokens": tokens}, cfg, pad_to=640)
        got, card_cache = prefill(place_params(params, dev),
                                  {"tokens": tokens.to(dev)}, cfg, pad_to=640)
    assert flash_prefill.flash_prefill.launches == launches
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=0)
    for c, g in zip(cache["layers"][0], card_cache["layers"][0]):
        if c.dtype == torch.int8 and tier == "int8":
            assert (c.int() - g.cpu().int()).abs().max() <= 1


def test_greedy_spec_engine_on_the_card_equals_generate(dev):
    """A short greedy speculative run on the card (stablelm smoke in f32,
    dynamic-int8 draft, paged and dense) gives the target's own
    ``generate`` streams."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import init_params
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     InferenceSession, SpecConfig)

    cfg = configs.smoke_config("stablelm-1.6b").with_overrides(
        dtype="float32")
    params = init_params(cfg, seed=0, device=dev)
    draft, _ = VariantSpec.dynamic_int8().build(params, cfg)
    session = InferenceSession(params, cfg, device=dev)
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=gen)
               for n in (9, 17, 30)]
    want = [session.generate({"tokens": p}, 10)[0].tolist() for p in prompts]
    for kw in ({}, dict(paged=True, block_size=16)):
        engine = ContinuousBatchingEngine(
            session, n_slots=2, max_len=64,
            spec=SpecConfig(draft=(draft, cfg), k=3), **kw)
        reqs = [engine.submit(p, max_new_tokens=10) for p in prompts]
        engine.run()
        assert [r.out_tokens for r in reqs] == want
        assert engine.metrics()["spec_events"] > 0


# --------------------------------------------------------------------- #
# Tensor-parallel serving: two shards on one card
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("combine", ["exact", "psum"])
def test_row_combine_two_shards_on_one_card(dev, combine):
    """Both shards' threads on the card's default stream: exact gathers
    and applies the full wo (tp=1's contraction), psum all-reduces the
    row-parallel partials in rank order (every rank the same bits)."""
    from repro_torch.models.layers import linear, row_combine
    from repro_torch.models.sharding import ShardGroup

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((8, 1, 4096), generator=gen, device=dev)
    wo = torch.randn((4096, 5120), generator=gen, device=dev) / 64
    group = ShardGroup([dev, dev], combine)
    try:
        def body(r):
            xs = x[..., r * 2048:(r + 1) * 2048]
            w = wo if combine == "exact" else wo[r * 2048:(r + 1) * 2048]
            return row_combine(w, xs)

        with torch.no_grad():
            outs = group.run(body)
    finally:
        group.close()
    assert torch.equal(outs[0], outs[1])
    want = linear(wo, x)
    if combine == "exact":
        assert torch.equal(outs[0], want)
    else:
        torch.testing.assert_close(outs[0], want, rtol=1e-5, atol=1e-4)


def _tp_cfg():
    # the per-shard attention shapes of mistral-nemo-12b at tp=2 (Hq 16,
    # Hkv 4, G 4, hd 128) in a 2-layer, 512-wide f32 stack
    from repro_torch import configs

    return configs.smoke_config("mistral-nemo-12b").with_overrides(
        n_layers=2, d_model=512, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=1024, dtype="float32")


@pytest.mark.parametrize("tier", ["fp", "int8", "int4"])
def test_tp2_paged_decode_step_on_the_card(dev, tier):
    """One paged prefill and decode step at tp=2 against tp=1 on the same
    weights and blocks: the per-shard paged decode kernel launches once a
    layer a shard (2 x layers), the logits agree with tp=1's."""
    from repro_torch.models import (decode_step_paged, init_params,
                                    prefill_paged)
    from repro_torch.serving.kvcache import init_paged_pools
    from repro_torch.serving.sharded import TPContext

    cfg = _tp_cfg().with_overrides(kv_cache_precision=tier)
    params = init_params(cfg, seed=0, device=dev)
    kernel = {"fp": paged_attn.paged_decode,
              "int8": paged_attn.paged_qdecode,
              "int4": paged_attn.paged_q4decode}[tier]
    tables = torch.tensor([[3, 1, 4, -1]], dtype=torch.int32, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(6))
    batch = {"tokens": torch.nn.functional.pad(tokens, (0, 8)).to(dev)}
    nxt = tokens[:, :1].to(dev)
    pos = torch.tensor([40], device=dev)
    ctx = TPContext(cfg, 2, params=params, devices=[dev, dev])
    try:
        with torch.no_grad():
            pools = init_paged_pools(cfg, 6, 16, device=dev)
            prefill_paged(params, pools, batch, 40, tables, cfg)
            want, _ = decode_step_paged(params, pools, nxt, pos, tables, cfg)
            sp = ctx.shard_params(params)
            spools = ctx.shard_cache(init_paged_pools(cfg, 6, 16,
                                                      device=dev))
            ctx.prefill_paged(sp, spools, batch, 40, tables)
            before = kernel.launches
            got, _ = ctx.decode_step_paged(sp, spools, nxt, pos, tables)
            torch.cuda.synchronize()
    finally:
        ctx.group.close()
    assert kernel.launches - before == 2 * cfg.n_layers
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


def test_launch_counters_exact_under_two_threads(dev):
    """Two threads launch the paged decode kernel at the same time, as
    callers outside a ``ShardGroup`` may (a group's shards take turns):
    the wrapper's count is exactly the launches of both."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((8, 4, 4, 128), generator=gen, device=dev)
    kp = torch.randn((33, 16, 4, 128), generator=gen, device=dev)
    vp = torch.randn((33, 16, 4, 128), generator=gen, device=dev)
    tables = torch.arange(1, 33, dtype=torch.int32, device=dev).reshape(8, 4)
    pos = torch.full((8,), 60, dtype=torch.int32, device=dev)
    start = threading.Barrier(2)
    outs = [None, None]

    def launch(i):
        start.wait()
        with torch.no_grad():
            for _ in range(500):
                outs[i] = paged_attn.paged_decode(q, kp, vp, tables, pos)

    before = paged_attn.paged_decode.launches
    threads = [threading.Thread(target=launch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert paged_attn.paged_decode.launches - before == 1000
    assert torch.equal(outs[0], outs[1])
