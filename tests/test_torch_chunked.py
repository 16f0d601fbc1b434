"""The rest of the port's dense model against the JAX package: the
chunked-query prefill (``opt_flash_prefill=False``: ``chunked_attention``,
the non-flash ``gqa_prefill`` / ``gqa_prefill_paged`` with their
quantize-after-padding caches), ``opt_attn_accum`` (f32 score operands) at
bf16, and the phi3-mini and deepseek-7b configs, on bridged weights."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import decode_step_paged as j_decode_paged  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import prefill_paged as j_prefill_paged  # noqa: E402
from repro.serving import kvcache as j_kv  # noqa: E402
from repro.serving.engine import InferenceSession as JSession  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import cache_to_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import decode_step_paged as t_decode_paged  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402
from repro_torch.models import prefill as t_prefill  # noqa: E402
from repro_torch.models import prefill_paged as t_prefill_paged  # noqa: E402
from repro_torch.models.config import check_supported  # noqa: E402
from repro_torch.serving import InferenceSession  # noqa: E402
from repro_torch.serving import kvcache as t_kv  # noqa: E402

_jit = functools.partial(jax.jit, static_argnames=("cfg",))
j_prefill_jit = jax.jit(j_prefill, static_argnames=("cfg", "pad_to"))
j_decode_jit, j_prefill_paged_jit, j_decode_paged_jit = (
    _jit(j_decode), _jit(j_prefill_paged), _jit(j_decode_paged))
TIERS = ("fp", "int8", "int4")


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).reshape(-1)


def _qkv(rng, b, s, hq, hkv, hd):
    return tuple(rng.standard_normal((b, s, h, hd)).astype(np.float32)
                 for h in (hq, hkv, hkv))


# --------------------------------------------------------------------- #
# chunked_attention
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("s", [40, 600])          # one chunk; two + 424 pad
@pytest.mark.parametrize("hq, hkv", [(4, 2), (4, 4), (8, 1)])
@pytest.mark.parametrize("window", [0, 100])
def test_chunked_attention_matches_jax(s, hq, hkv, window):
    """f32, GQA: within 1e-5 of JAX (seen <= 5e-7). S = 600 takes two
    query chunks of 512, the second padded with 424 rows masked by
    absolute position; a window reads only its K/V band."""
    q, k, v = _qkv(np.random.default_rng(s + hq), 2, s, hq, hkv, 32)
    want = np.asarray(j_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(s),
        window=window))
    got = t_attn.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.arange(s), window=window).numpy()
    assert got.shape == want.shape == (2, s, hq, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the chunked core is the flash kernel's plain reference's function
    if not window:
        flash = t_ops.flash_prefill(*(torch.from_numpy(a)
                                      for a in (q, k, v))).numpy()
        np.testing.assert_allclose(got, flash, atol=1e-5, rtol=0)


@pytest.mark.parametrize("s", [40, 600])
@pytest.mark.parametrize("native", [True, False])
def test_attn_accum_at_bf16_matches_jax(s, native):
    """bf16 operands: ``native`` (``opt_attn_accum``) takes exact products
    in f32 (JAX: bf16 operands, f32 result) in another summation order, so
    the bf16 outputs may differ by one bf16 rounding: at most one bf16 ulp
    of the largest output (2^-7 of max |out|), on under 1% of elements."""
    q, k, v = _qkv(np.random.default_rng(3), 2, s, 4, 2, 32)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in jb]
    want = np.asarray(j_attn.chunked_attention(
        *jb, jnp.arange(s), native_accum=native).astype(jnp.float32))
    got = t_attn.chunked_attention(*tb, torch.arange(s),
                                   native_accum=native).float().numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 ** -7 * np.abs(want).max(), diff.max()
    assert (diff > 0).mean() < 0.01


def test_score_einsum_native_is_f32_without_bf16_rounding():
    a = torch.tensor([[1.0 + 2 ** -7]], dtype=torch.bfloat16)
    b = torch.tensor([[1.0 + 2 ** -7]], dtype=torch.bfloat16)
    exact = (1.0 + 2 ** -7) ** 2                    # not a bf16 value
    native = t_attn._score_einsum("ik,jk->ij", a, b, True)
    plain = t_attn._score_einsum("ik,jk->ij", a, b, False)
    assert native.dtype == plain.dtype == torch.float32
    assert float(native) == exact and float(plain) != exact


# --------------------------------------------------------------------- #
# Non-flash gqa_prefill / gqa_prefill_paged caches, bit for bit
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def nemo():
    arch = "mistral-nemo-12b"                      # GQA 4:2, hd 32
    jcfg = j_configs.smoke_config(arch).with_overrides(dtype="float32")
    tcfg = t_configs.smoke_config(arch).with_overrides(dtype="float32")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture
def exact_rope(monkeypatch):
    """RoPE as the identity in both packages: XLA's and torch's cos / sin
    differ by an ulp, which moves K by an ulp and so its scales; without
    RoPE, K and V leave both packages' f32 matmuls bit-identical, and the
    caches are held bit for bit (the model tests below hold logits)."""
    ident = lambda x, positions, theta: x                 # noqa: E731
    monkeypatch.setattr(j_attn, "apply_rope", ident)
    monkeypatch.setattr(t_attn, "apply_rope", ident)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("s", [40, 600])
def test_chunked_prefill_cache_bit_identical(nemo, exact_rope, tier, s):
    """The chunked path quantizes the *padded* K/V (pad rows take the floor
    scale), the flash path quantizes first and pads codes and scales with
    zeros: both match JAX bit for bit, and both hold the same codes over
    the prompt."""
    jcfg, tcfg, jp, tp = nemo
    x = np.random.default_rng(s).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = tp["layers"][0]["attn"]
    caches = {}
    for flash in (False, True):
        jc = jcfg.with_overrides(kv_cache_precision=tier,
                                 opt_flash_prefill=flash)
        tc = tcfg.with_overrides(kv_cache_precision=tier,
                                 opt_flash_prefill=flash)
        jo, jcache = j_attn.gqa_prefill(jl, jnp.asarray(x), jnp.arange(s),
                                        jc, pad_to=s + 24)
        with torch.no_grad():
            to, tcache = t_attn.gqa_prefill(tl, torch.from_numpy(x),
                                            torch.arange(s), tc,
                                            pad_to=s + 24)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4,
                                   rtol=0)
        assert len(tcache) == (2 if tier == "fp" else 4)
        for j, t in zip(jcache, tcache):
            assert np.asarray(j).dtype == t.numpy().dtype
            assert np.array_equal(_bits(j), _bits(t.numpy()))
        caches[flash] = tcache
    for c, f in zip(caches[False], caches[True]):
        assert torch.equal(c[:, :s], f[:, :s])
    if tier == "int8":              # pads: floor scale (chunked), 0 (flash)
        assert bool((caches[False][1][:, s:] > 0).all())
        assert bool((caches[True][1][:, s:] == 0).all())


@pytest.mark.parametrize("tier", TIERS)
def test_chunked_paged_prefill_pools_bit_identical(nemo, exact_rope, tier):
    """``gqa_prefill_paged`` without flash: the chunked core attends over the
    fp K/V and the codes scatter through the table, bit for bit JAX's
    (a 600-token prompt, its bucket pads in the trash block)."""
    jcfg, tcfg, jp, tp = nemo
    jc = jcfg.with_overrides(kv_cache_precision=tier, opt_flash_prefill=False)
    tc = tcfg.with_overrides(kv_cache_precision=tier, opt_flash_prefill=False)
    s, n, bs = 640, 600, 16
    x = np.random.default_rng(9).standard_normal(
        (1, s, jcfg.d_model)).astype(np.float32)
    table = np.full((1, 48), -1, np.int32)
    table[0, :38] = np.random.default_rng(1).permutation(np.arange(1, 39))
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = tp["layers"][0]["attn"]
    jpools = j_kv.init_paged_pools(jc, 40, bs)["layers"]
    jpools = tuple(a[0] for a in jpools)
    tpools = t_kv.init_paged_pools(tc, 40, bs, device="cpu")["layers"][0]
    jo, jpools = j_attn.gqa_prefill_paged(jl, jnp.asarray(x), jnp.arange(s),
                                          jpools, n, jnp.asarray(table), jc)
    with torch.no_grad():
        to, tpools = t_attn.gqa_prefill_paged(
            tl, torch.from_numpy(x), torch.arange(s), tpools, n,
            torch.from_numpy(table), tc)
    np.testing.assert_allclose(to.numpy()[:, :n], np.asarray(jo)[:, :n],
                               atol=1e-4, rtol=0)
    for j, t in zip(jpools, tpools):
        j, t = np.asarray(j)[1:], t.numpy()[1:]          # not the trash
        assert np.array_equal(_bits(j), _bits(t))


# --------------------------------------------------------------------- #
# The model through the chunked path, against JAX
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("variant", ["fp32", "int4"])
def test_chunked_model_logits_match_jax(nemo, tier, variant):
    """``opt_flash_prefill=False`` end to end: dense and paged prefill then
    4 decode steps, f32 logits within 1e-4 of JAX's, greedy tokens equal
    (fp32 and weight-only int4 weights; dynamic int8's activation codes
    flip where an activation sits an ulp from a rounding boundary, see
    ``test_new_configs_dynamic_int8_streams_match_jax``)."""
    jcfg, tcfg, jp, tp = nemo
    jc = jcfg.with_overrides(kv_cache_precision=tier, opt_flash_prefill=False)
    tc = tcfg.with_overrides(kv_cache_precision=tier, opt_flash_prefill=False)
    check_supported(tc)
    if variant == "int4":
        jp, tp = JSpec.int4().build(jp, jc)[0], TSpec.int4().build(tp, tc)[0]
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size, (1, 21))
    padded = np.pad(prompt, ((0, 0), (0, 11)))
    table = np.array([[5, 2, 7, 1, -1, -1]], np.int32)
    jpools = j_kv.init_paged_pools(jc, 8, 8)
    tpools = t_kv.init_paged_pools(tc, 8, 8, device="cpu")
    jl, jcache = j_prefill_jit(jp, {"tokens": jnp.asarray(prompt)}, cfg=jc,
                               pad_to=32)
    jpl, jpools = j_prefill_paged_jit(jp, jpools,
                                      {"tokens": jnp.asarray(padded)},
                                      jnp.int32(21), jnp.asarray(table), cfg=jc)
    with torch.no_grad():
        tl, tcache = t_prefill(tp, {"tokens": torch.as_tensor(prompt)}, tc,
                               pad_to=32)
        tpl, _ = t_prefill_paged(tp, tpools, {"tokens": torch.as_tensor(
            padded)}, 21, torch.as_tensor(table), tc)
    for a, b in ((tl, jl), (tpl, jpl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    tok = int(np.argmax(np.asarray(jl)[0, -1]))
    for i in range(4):
        pos = 21 + i
        t1 = np.array([[tok]])
        jl, jcache = j_decode_jit(jp, jcache, jnp.asarray(t1), pos, cfg=jc)
        jpl, jpools = j_decode_paged_jit(jp, jpools, jnp.asarray(t1),
                                         jnp.asarray([pos], jnp.int32),
                                         jnp.asarray(table), cfg=jc)
        with torch.no_grad():
            tl, tcache = t_decode(tp, tcache, torch.as_tensor(t1), pos, tc)
            tpl, _ = t_decode_paged(tp, tpools, torch.as_tensor(t1),
                                    torch.tensor([pos]),
                                    torch.as_tensor(table), tc)
        for a, b in ((tl, jl), (tpl, jpl)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                       rtol=0)
        assert int(torch.argmax(tl[0, -1])) == int(np.argmax(
            np.asarray(jl)[0, -1]))
        tok = int(np.argmax(np.asarray(jl)[0, -1]))
    back = cache_to_jax(tcache)["layers"]
    assert [a.shape for a in back] == [np.asarray(a).shape
                                       for a in jcache["layers"]]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mistral-nemo-12b"])
@pytest.mark.parametrize("flash", [True, False])
def test_attn_accum_bf16_model_within_twice_jax_own_bf16_delta(arch, flash):
    """``opt_attn_accum=True`` on the bf16 smoke model (decode's score
    product, and the chunked prefill's when ``flash`` is off): the port's
    logits within twice what JAX's own bf16 logits differ from its f32
    ones (the convention of tests/test_torch_bf16.py)."""
    over = dict(opt_attn_accum=True, opt_flash_prefill=flash)
    jcfg = j_configs.smoke_config(arch).with_overrides(**over)
    tcfg = t_configs.smoke_config(arch).with_overrides(**over)
    check_supported(tcfg)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    jcfg32 = jcfg.with_overrides(dtype="float32")
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 24))
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 1))

    def j_run(p, cfg):
        l0, c = j_prefill(p, {"tokens": jnp.asarray(prompt)}, cfg, pad_to=32)
        l1, _ = j_decode(p, c, jnp.asarray(toks), 24, cfg)
        return np.asarray(l0), np.asarray(l1)

    with torch.no_grad():
        l0, c = t_prefill(tp, {"tokens": torch.as_tensor(prompt)}, tcfg,
                          pad_to=32)
        l1, _ = t_decode(tp, c, torch.as_tensor(toks), 24, tcfg)
    for got, want, f32 in zip((l0.numpy(), l1.numpy()), j_run(jp, jcfg),
                              j_run(jp32, jcfg32)):
        own = np.abs(want - f32).max()
        assert 0 < own < 0.2
        assert np.abs(got - want).max() <= 2 * own


# --------------------------------------------------------------------- #
# phi3-mini and deepseek-7b
# --------------------------------------------------------------------- #
NEW_ARCHS = ["phi3-mini-3.8b", "deepseek-7b"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_copy_jax(arch):
    """The published and smoke configs are the JAX package's field for
    field, registered under the JAX aliases."""
    for get in ("get_config", "smoke_config"):
        j = getattr(j_configs, get)(arch)
        t = getattr(t_configs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        check_supported(t)
    cfg = t_configs.get_config(arch)
    assert cfg.arch_type == "dense" and cfg.n_heads == cfg.n_kv_heads == 32


def test_unregistered_archs_name_their_item():
    # mamba2 and recurrentgemma are served since item 9's recurrent slice,
    # musicgen since its last
    for arch in ("mamba2-780m", "recurrentgemma-9b", "musicgen-large"):
        check_supported(t_configs.get_config(arch))
    with pytest.raises(KeyError, match="unknown architecture"):
        t_configs.get_config("gpt-17")


def _new_arch(arch, variant):
    jcfg = j_configs.smoke_config(arch).with_overrides(dtype="float32")
    tcfg = t_configs.smoke_config(arch).with_overrides(dtype="float32")
    jp = j_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jq = getattr(JSpec, variant)().build(jp, jcfg)[0]
    tq = getattr(TSpec, variant)().build(tp, tcfg)[0]
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 19))
    want = np.asarray(j_forward(jq, {"tokens": jnp.asarray(tokens)},
                                jcfg)[0])
    with torch.no_grad():
        got = t_forward(tq, {"tokens": torch.as_tensor(tokens)},
                        tcfg)[0].numpy()
    return jcfg, tcfg, jq, tq, tokens, got, want


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("variant", ["fp32", "int4"])
def test_new_configs_logits_and_streams_match_jax(arch, variant):
    """Smoke logits within 1e-4 of JAX in f32 and greedy ``generate``
    streams token for token, for fp32 and weight-only int4 weights."""
    jcfg, tcfg, jq, tq, tokens, got, want = _new_arch(arch, variant)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _same_streams(jcfg, tcfg, jq, tq, tokens)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_dynamic_int8_streams_match_jax(arch):
    """Dynamic int8: each linear quantizes its input rows, so an activation
    that the f32 matmuls before it leave an ulp from a rounding boundary
    flips one code and moves the logits by up to one code step's product
    (0.049 seen here; the card-vs-CPU bound of ``chip_smoke.py`` is 0.2).
    The mean stays small and greedy streams are equal."""
    jcfg, tcfg, jq, tq, tokens, got, want = _new_arch(arch, "dynamic_int8")
    assert np.abs(got - want).max() <= 0.1
    assert np.abs(got - want).mean() <= 0.01
    _same_streams(jcfg, tcfg, jq, tq, tokens)


def _same_streams(jcfg, tcfg, jq, tq, tokens):
    j_stream = np.asarray(JSession(jq, jcfg).generate(
        {"tokens": jnp.asarray(tokens)}, 10))
    t_stream = InferenceSession(tq, tcfg, device="cpu").generate(
        {"tokens": torch.as_tensor(tokens)}, 10).numpy()
    np.testing.assert_array_equal(t_stream, j_stream)

