"""The port's Multi-head Latent Attention (deepseek-v2) against the JAX
package on the fp32 smoke config (rank 64, qk_nope 32 + qk_rope 16, v 32):
prefill (flash, its Pallas kernel in interpret mode, and chunked), paged
prefill, naive, absorbed and paged decode, dense and paged verify; the
absorbed path over a quantized and a card-packed ``w_ukv``; the compressed
caches and pools (shapes, bridge both ways, accounting); the whole model's
flash and chunked prefills."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.backends import use_backend  # noqa: E402
from repro.core.quant import QuantConfig as JQC  # noqa: E402
from repro.core.quant import quantize_tree as j_quantize_tree  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serving import kvcache as j_kv  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import (cache_from_jax, cache_to_jax,  # noqa: E402
                                params_from_jax, to_torch)
from repro_torch.core.quant import QuantConfig as TQC  # noqa: E402
from repro_torch.core.quant import quantize_tree as t_quantize_tree  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import init_cache as t_init_cache  # noqa: E402
from repro_torch.models import prefill as t_prefill  # noqa: E402
from repro_torch.models.layers import place_params  # noqa: E402
from repro_torch.serving import kvcache as t_kv  # noqa: E402

ARCH = "deepseek-v2-236b"
ATOL = 1e-4
B, S, PAD = 2, 21, 32
BS = 8                                   # pool block size
# per sequence: scattered block ids, -1 past the blocks it owns
TABLES = np.array([[3, 1, 6, -1], [2, 5, 4, 7]], np.int32)
N_BLOCKS = 8


def _cfgs(**over):
    return (j_configs.smoke_config(ARCH).with_overrides(dtype="float32",
                                                       **over),
            t_configs.smoke_config(ARCH).with_overrides(dtype="float32",
                                                       **over))


@pytest.fixture(scope="module")
def attn_params():
    jcfg, _ = _cfgs()
    jp = j_attn.init_mla_params(jax.random.PRNGKey(5), jcfg)
    return jp, jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), jp)


def _x(m, seed):
    jcfg, _ = _cfgs()
    return np.random.default_rng(seed).standard_normal(
        (B, m, jcfg.d_model)).astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


def _clone(cache):
    return tuple(t.clone() for t in cache)


@pytest.mark.parametrize("flash", [True, False])
def test_mla_prefill_matches_jax(attn_params, flash):
    jp, tp = attn_params
    jcfg, tcfg = _cfgs(opt_flash_prefill=flash)
    x = _x(S, 1)
    with use_backend("pallas-interpret"):
        jo, jc = j_attn.mla_prefill(jp, jnp.asarray(x), jnp.arange(S), jcfg,
                                    pad_to=PAD)
    calls = []
    real = t_ops.flash_prefill

    def spy(q, k, v):
        calls.append((tuple(q.shape), tuple(v.shape), k.is_contiguous(),
                      v.is_contiguous()))
        return real(q, k, v)

    t_ops.flash_prefill = spy
    try:
        to, tc = t_attn.mla_prefill(tp, torch.as_tensor(x),
                                    torch.arange(S), tcfg, pad_to=PAD)
    finally:
        t_ops.flash_prefill = real
    _close(to, jo, "out")
    for t, j in zip(tc, jc):
        assert tuple(t.shape) == j.shape
        _close(t, j, "cache")
    # one kv head per query head, hd = qk_nope + qk_rope, dv = v_head_dim;
    # k and v contiguous for the kernel
    assert calls == ([((B, S, 4, 48), (B, S, 4, 32), True, True)]
                     if flash else [])


def _pools(seed):
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((N_BLOCKS, BS, w)).astype(np.float32)
                 for w in (jcfg.kv_lora_rank, jcfg.qk_rope_dim))


@pytest.mark.parametrize("flash", [True, False])
def test_mla_prefill_paged_matches_jax(attn_params, flash):
    jp, tp = attn_params
    jcfg, tcfg = _cfgs(opt_flash_prefill=flash)
    x = _x(S, 2)
    pools = _pools(3)
    n_valid = 19                   # the last two positions are padding
    with use_backend("pallas-interpret"):
        jo, jpools = j_attn.mla_prefill_paged(
            jp, jnp.asarray(x), jnp.arange(S), tuple(map(jnp.asarray, pools)),
            n_valid, jnp.asarray(TABLES), jcfg)
    tpools = tuple(torch.as_tensor(p.copy()) for p in pools)
    to, tpools = t_attn.mla_prefill_paged(
        tp, torch.as_tensor(x), torch.arange(S), tpools, n_valid,
        torch.as_tensor(TABLES), tcfg)
    _close(to, jo, "out")
    # block 0 (trash) takes the padding's writes: compare the owned blocks
    for t, j in zip(tpools, jpools):
        _close(t[1:], np.asarray(j)[1:], "pools")


def _dense_cache(seed, s_cache=PAD):
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, s_cache, w)).astype(np.float32)
                 for w in (jcfg.kv_lora_rank, jcfg.qk_rope_dim))


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_matches_jax(attn_params, absorb):
    jp, tp = attn_params
    jcfg, tcfg = _cfgs(opt_mla_absorb=absorb)
    cache = _dense_cache(4)
    pos = np.array([9, 27], np.int32)
    x = _x(1, 5)
    jo, jc = j_attn.mla_decode(jp, jnp.asarray(x),
                               tuple(map(jnp.asarray, cache)),
                               jnp.asarray(pos), jcfg)
    to, tc = t_attn.mla_decode(tp, torch.as_tensor(x),
                               tuple(torch.as_tensor(c.copy())
                                     for c in cache),
                               torch.as_tensor(pos), tcfg)
    _close(to, jo, "out")
    for t, j in zip(tc, jc):
        _close(t, j, "cache")


def test_absorbed_decode_agrees_with_naive(attn_params):
    """The two decode paths are one function of the cache (up to f32
    rounding): the absorbed one folds W_uk and W_uv into the query and
    the output."""
    _, tp = attn_params
    _, naive = _cfgs()
    _, absorbed = _cfgs(opt_mla_absorb=True)
    cache = tuple(torch.as_tensor(c) for c in _dense_cache(6))
    x, pos = torch.as_tensor(_x(1, 7)), torch.tensor([5, 30])
    a, _ = t_attn.mla_decode(tp, x, _clone(cache), pos, naive)
    b, _ = t_attn.mla_decode(tp, x, _clone(cache), pos, absorbed)
    torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def test_absorbed_decode_reads_quantized_and_packed_w_ukv(attn_params):
    """A dynamic-int8 ``w_ukv`` is dequantized by the absorbed path, as in
    JAX; packed K-major for the card's GEMMs (``place_params``), it is read
    back as the same codes."""
    jp, tp = attn_params
    jcfg, tcfg = _cfgs(opt_mla_absorb=True)
    jq, _ = j_quantize_tree(jp, JQC(min_size=1024))
    tq, paths = t_quantize_tree(tp, TQC(min_size=1024))
    assert "w_ukv" in paths and "w_kr" not in paths
    cache = _dense_cache(8)
    x, pos = _x(1, 9), np.array([11, 3], np.int32)
    jo, _ = j_attn.mla_decode(jq, jnp.asarray(x),
                              tuple(map(jnp.asarray, cache)),
                              jnp.asarray(pos), jcfg)
    outs = []
    for tree in (tq, place_params(tq, "cpu", pack=True)):
        o, _ = t_attn.mla_decode(tree, torch.as_tensor(x),
                                 tuple(torch.as_tensor(c.copy())
                                       for c in cache),
                                 torch.as_tensor(pos), tcfg)
        outs.append(o)
    packed = place_params(tq, "cpu", pack=True)
    assert "w_packed" in packed["w_ukv"] and "w_int8" not in packed["w_ukv"]
    rank = tcfg.kv_lora_rank
    assert torch.equal(t_attn._w_ukv(tq, rank, torch.float32),
                       t_attn._w_ukv(packed, rank, torch.float32))
    _close(outs[0], jo, "quantized")
    # the packed GEMMs' plain version sums in another order
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_paged_matches_jax(attn_params, absorb):
    jp, tp = attn_params
    jcfg, tcfg = _cfgs(opt_mla_absorb=absorb)
    pools = _pools(10)
    pos = np.array([17, 30], np.int32)
    x = _x(1, 11)
    jo, jpools = j_attn.mla_decode_paged(
        jp, jnp.asarray(x), tuple(map(jnp.asarray, pools)), jnp.asarray(pos),
        jnp.asarray(TABLES), jcfg)
    to, tpools = t_attn.mla_decode_paged(
        tp, torch.as_tensor(x), tuple(torch.as_tensor(p.copy())
                                      for p in pools),
        torch.as_tensor(pos), torch.as_tensor(TABLES), tcfg)
    _close(to, jo, "out")
    for t, j in zip(tpools, jpools):
        _close(t, j, "pools")


def test_mla_verify_matches_jax_and_sequential_decode(attn_params):
    jp, tp = attn_params
    jcfg, tcfg = _cfgs()
    m = 4
    cache = _dense_cache(12)
    pos = np.array([6, 20], np.int32)
    x = _x(m, 13)
    jo, jc = j_attn.mla_verify(jp, jnp.asarray(x),
                               tuple(map(jnp.asarray, cache)),
                               jnp.asarray(pos), jcfg)
    tcache = tuple(torch.as_tensor(c.copy()) for c in cache)
    to, tc = t_attn.mla_verify(tp, torch.as_tensor(x), tcache,
                               torch.as_tensor(pos), tcfg)
    _close(to, jo, "out")
    for t, j in zip(tc, jc):
        _close(t, j, "cache")
    # query i of the span is what the i-th sequential decode step gives
    seq = tuple(torch.as_tensor(c.copy()) for c in cache)
    for i in range(m):
        o, seq = t_attn.mla_decode(tp, torch.as_tensor(x[:, i:i + 1]), seq,
                                   torch.as_tensor(pos + i), tcfg)
        torch.testing.assert_close(o[:, 0], to[:, i], atol=1e-5, rtol=0)


def test_mla_verify_paged_matches_jax(attn_params):
    jp, tp = attn_params
    jcfg, tcfg = _cfgs()
    pools = _pools(14)
    pos = np.array([13, 27], np.int32)
    x = _x(3, 15)
    jo, jpools = j_attn.mla_verify_paged(
        jp, jnp.asarray(x), tuple(map(jnp.asarray, pools)), jnp.asarray(pos),
        jnp.asarray(TABLES), jcfg)
    to, tpools = t_attn.mla_verify_paged(
        tp, torch.as_tensor(x), tuple(torch.as_tensor(p.copy())
                                      for p in pools),
        torch.as_tensor(pos), torch.as_tensor(TABLES), tcfg)
    _close(to, jo, "out")
    for t, j in zip(tpools, jpools):
        _close(t, j, "pools")


# --------------------------------------------------------------------- #
# caches, pools, bridge, accounting
# --------------------------------------------------------------------- #
def test_caches_and_pools_match_jax_layout():
    jcfg, tcfg = _cfgs()
    jc = j_init_cache(jcfg, 3, 40)
    tc = t_init_cache(tcfg, 3, 40, device="cpu")
    assert set(tc) == set(jc) == {"head_layers", "layers"}
    for key in jc:
        assert [tuple(np.asarray(f).shape) for f in jc[key]] == [
            (len(tc[key]),) + tuple(t.shape) for t in tc[key][0]]
    jpools = j_kv.init_paged_pools(jcfg, 5, 4)
    tpools = t_kv.init_paged_pools(tcfg, 5, 4, device="cpu")
    for key in jpools:
        assert [tuple(np.asarray(f).shape) for f in jpools[key]] == [
            (len(tpools[key]),) + tuple(t.shape) for t in tpools[key][0]]
    # MLA keeps its compressed streams whatever the KV tier
    for tier in ("int8", "int4"):
        jt, tt = _cfgs(kv_cache_precision=tier)
        assert [t.dtype for t in t_kv.init_paged_pools(
            tt, 2, 4, device="cpu")["layers"][0]] == [torch.float32] * 2
        assert t_kv.kv_bytes_per_token(tt) == j_kv.kv_bytes_per_token(jt) \
            == (64 + 16) * 4


def test_cache_bridge_round_trips_both_stacks():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(16)
    tree = {key: tuple(rng.standard_normal(np.asarray(f).shape)
                       .astype(np.float32) for f in fields)
            for key, fields in j_kv.init_paged_pools(jcfg, 3, 4).items()}
    port = cache_from_jax(tree, "cpu")
    assert len(port["head_layers"]) == 1 and len(port["layers"]) == 1
    back = cache_to_jax(port)
    for key in tree:
        for a, b in zip(tree[key], back[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flash", [True, False])
def test_model_prefill_matches_jax(flash):
    """The whole deepseek-v2 smoke model (dense head layer + MoE layer,
    MLA in both), flash and chunked prefill, caches of both stacks."""
    jcfg, tcfg = _cfgs(opt_flash_prefill=flash)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(17).integers(0, jcfg.vocab_size, (2, 30))
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, pad_to=40)
    tl, tc = t_prefill(tp, {"tokens": torch.as_tensor(toks)}, tcfg,
                       pad_to=40)
    _close(tl, jl, "logits")
    back = cache_to_jax(tc)
    for key in jc:
        for t, j in zip(back[key], jc[key]):
            _close(t, j, key)
