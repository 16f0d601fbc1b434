"""The port's paged KV cache against the JAX package: the paged-attention
plain version against the Pallas kernel (interpret mode), paged prefill and
decode on bridged weights, the block allocator and the pools. The CUDA
kernel is held against the plain version in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hypothesis_compat import given, settings, st  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.paged_attn import paged_decode_attention  # noqa: E402
from repro.models import decode_step_paged as j_decode_paged  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import prefill_paged as j_prefill_paged  # noqa: E402
from repro.serving import kvcache as j_kv  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import (cache_from_jax, cache_to_jax,  # noqa: E402
                                params_from_jax)
from repro_torch.kernels import ops, paged_attn  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import decode_step_paged as t_decode_paged  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.models import prefill as t_prefill  # noqa: E402
from repro_torch.models import prefill_paged as t_prefill_paged  # noqa: E402
from repro_torch.serving import kvcache as t_kv  # noqa: E402

ARCHS = ["stablelm-1.6b", "mistral-nemo-12b"]


# ------------------------------------------------------------------ #
# The kernel's plain version against the Pallas kernel
# ------------------------------------------------------------------ #
def _paged_case(seed, b, hkv, g, hd, bs, m, pos, holes=()):
    """Random q and pools; each sequence's table holds shuffled block ids
    for the entries its position reaches and -1 past its end; ``holes``
    lists (b, m) entries set to -1 inside that range."""
    rng = np.random.default_rng(seed)
    n = b * m + 3
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    k_pool = rng.normal(size=(n, bs, hkv, hd)).astype(np.float32)
    v_pool = rng.normal(size=(n, bs, hkv, hd)).astype(np.float32)
    ids = iter(rng.permutation(np.arange(1, n)))
    tables = np.full((b, m), -1, np.int32)
    for i, p in enumerate(pos):
        for j in range(p // bs + 1):
            tables[i, j] = next(ids)
    for i, j in holes:
        tables[i, j] = -1
    return q, k_pool, v_pool, tables, np.asarray(pos, np.int32)


def _jax_kernel(*arrays):
    return np.asarray(paged_decode_attention(
        *(jnp.asarray(a) for a in arrays), interpret=True))


def _port_ref(*arrays):
    return t_ref.paged_decode_ref(*(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bs", [8, 16])
def test_paged_decode_ref_matches_pallas(g, hd, bs):
    # positions on a block's first slot, its last slot and inside it; one
    # -1 hole inside a sequence's reach
    pos = [0, 4 * bs - 1, 2 * bs, 3 * bs + 5]
    case = _paged_case(g * hd + bs, 4, 2, g, hd, bs, 5, pos, holes=[(3, 1)])
    want = _jax_kernel(*case)
    got = _port_ref(*case)
    assert got.dtype == torch.float32 and got.shape == case[0].shape
    # f32 both sides; one full-row softmax vs the kernel's online softmax
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_paged_oracle_helpers_match_jax():
    """paged_gather, paged_valid and _paged_bias: the JAX oracle's names,
    arity and values, -1 entries and positions past the table included."""
    _, k_pool, _, tables, pos = _paged_case(2, 3, 2, 2, 16, 4, 4, [5, 15, 3],
                                            holes=[(1, 2)])
    pos[2] = 40                                 # past the 4 x 4 table
    tj, pj = jnp.asarray(tables), jnp.asarray(pos)
    tt, pt = torch.from_numpy(tables), torch.from_numpy(pos)
    np.testing.assert_array_equal(
        t_ref.paged_gather(torch.from_numpy(k_pool), tt).numpy(),
        np.asarray(j_ref.paged_gather(jnp.asarray(k_pool), tj)))
    np.testing.assert_array_equal(t_ref.paged_valid(tt, pt, 4).numpy(),
                                  np.asarray(j_ref.paged_valid(tj, pj, 4)))
    np.testing.assert_array_equal(t_ref._paged_bias(tt, pt, 4).numpy(),
                                  np.asarray(j_ref._paged_bias(tj, pj, 4)))


def test_paged_decode_ref_idle_row_is_nan_and_isolated():
    """An idle engine slot (table all -1, pos 0) has no valid slot: the TPU
    kernel gives 0/0 there and so does the plain version. Whatever the
    trash block holds (even the NaN an idle row writes there) never reaches
    a live row."""
    q, k_pool, v_pool, tables, pos = _paged_case(3, 3, 2, 2, 64, 8, 4,
                                                 [12, 0, 20], holes=[(2, 1)])
    tables[1] = -1
    want = _jax_kernel(q, k_pool, v_pool, tables, pos)
    got = _port_ref(q, k_pool, v_pool, tables, pos).numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=1e-5, rtol=0)
    k_pool[0], v_pool[0] = np.nan, np.nan
    poisoned = _port_ref(q, k_pool, v_pool, tables, pos).numpy()
    np.testing.assert_array_equal(poisoned[[0, 2]], got[[0, 2]])


def test_paged_wrapper_checks_and_cpu_counts_no_launch():
    q, k_pool, v_pool, tables, pos = (torch.from_numpy(a) for a in _paged_case(
        5, 2, 2, 2, 32, 8, 3, [5, 17]))
    before = paged_attn.paged_decode.launches
    out = ops.paged_decode(q, k_pool, v_pool, tables, pos)
    assert torch.equal(out, t_ref.paged_decode_ref(q, k_pool, v_pool, tables,
                                                   pos))
    assert paged_attn.paged_decode.launches == before
    with pytest.raises(TypeError):
        paged_attn.paged_decode(q, k_pool, v_pool, tables.long(), pos)
    with pytest.raises(ValueError):            # block size must divide 32
        bad = torch.zeros(4, 12, 2, 32)
        paged_attn.paged_decode(q, bad, bad, tables, pos)
    with pytest.raises(ValueError):            # G > 8
        paged_attn.paged_decode(torch.zeros(2, 2, 9, 32), k_pool, v_pool,
                                tables, pos)
    with pytest.raises(ValueError):            # hd not a multiple of 8
        odd = torch.zeros(4, 8, 2, 12)
        paged_attn.paged_decode(torch.zeros(2, 2, 2, 12), odd, odd, tables,
                                pos)


# ------------------------------------------------------------------ #
# Paged prefill + decode on bridged weights
# ------------------------------------------------------------------ #
class _Pair:
    def __init__(self, arch):
        self.jcfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.jp = j_init(jax.random.PRNGKey(0), self.jcfg)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp),
                                  self.tcfg, "cpu")

    def variant(self, name):
        jspec, tspec = getattr(JSpec, name)(), getattr(TSpec, name)()
        return (jspec.build(self.jp, self.jcfg)[0],
                tspec.build(self.tp, self.tcfg)[0])


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _Pair(request.param)


BS, N_BLOCKS, MAX_BLOCKS = 4, 16, 6
# two sequences: prompt lengths, non-contiguous block ids, -1 tails
LENS = (10, 7)
TABLES = np.array([[9, 2, 14, 5, 11, -1], [3, 12, 7, 10, -1, -1]], np.int32)
N_STEPS = 6


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_paged_prefill_decode_match_jax_and_dense(pair, variant):
    jq, tq = pair.variant(variant)
    jcfg, tcfg = pair.jcfg, pair.tcfg
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, (1, n)) for n in LENS]
    j_pools = j_kv.init_paged_pools(jcfg, N_BLOCKS, BS)
    t_pools = t_kv.init_paged_pools(tcfg, N_BLOCKS, BS, device="cpu")
    t_dense = init_cache(tcfg, 2, 32, device="cpu")
    last_tok = []
    for i, p in enumerate(prompts):
        padded = np.pad(p, ((0, 0), (0, 16 - p.shape[1])))    # token bucket
        jl, j_pools = j_prefill_paged(jq, j_pools, {"tokens": jnp.asarray(
            padded)}, jnp.int32(LENS[i]), jnp.asarray(TABLES[i:i + 1]), jcfg)
        tl, _ = t_prefill_paged(tq, t_pools, {"tokens": torch.as_tensor(
            padded)}, LENS[i], torch.as_tensor(TABLES[i:i + 1]), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        dl, single = t_prefill(tq, {"tokens": torch.as_tensor(p)}, tcfg,
                               pad_to=32)
        for (kc, vc), (k1, v1) in zip(t_dense["layers"], single["layers"]):
            kc[i:i + 1], vc[i:i + 1] = k1, v1
        np.testing.assert_allclose(tl.numpy(), dl.numpy(), atol=1e-5, rtol=0)
        last_tok.append(int(torch.argmax(tl[0, -1])))
    tok = np.asarray(last_tok).reshape(2, 1)
    pos = np.asarray(LENS)
    tables_t = torch.as_tensor(TABLES)
    for _ in range(N_STEPS):
        jl, j_pools = j_decode_paged(jq, j_pools, jnp.asarray(tok),
                                     jnp.asarray(pos, jnp.int32),
                                     jnp.asarray(TABLES), jcfg)
        tl, _ = t_decode_paged(tq, t_pools, torch.as_tensor(tok),
                               torch.as_tensor(pos), tables_t, tcfg)
        dl, t_dense = t_decode(tq, t_dense, torch.as_tensor(tok),
                               torch.as_tensor(pos), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        # the twin of the JAX paged-vs-dense test: same port, two caches
        np.testing.assert_allclose(tl.numpy(), dl.numpy(), atol=1e-5, rtol=0)
        tok = torch.argmax(tl[:, -1], dim=-1).numpy().reshape(2, 1)
        pos = pos + 1
    # pools bridged back: every written slot holds JAX's K/V (f32 matmuls
    # and RoPE in another order: within 1e-5), and block 0 is never read
    jk, jv = (np.asarray(a) for a in j_pools["layers"])
    tk, tv = cache_to_jax(t_pools)["layers"]
    assert tk.shape == jk.shape
    for i in range(2):
        n_written = int(pos[i])
        blocks = TABLES[i, :-(-n_written // BS)]
        for want, got in ((jk, tk), (jv, tv)):
            w = want[:, blocks].reshape(want.shape[0], -1, *want.shape[3:])
            g = got[:, blocks].reshape(got.shape[0], -1, *got.shape[3:])
            np.testing.assert_allclose(g[:, :n_written], w[:, :n_written],
                                       atol=1e-5, rtol=0)


def test_cache_bridge_round_trips(pair):
    toks = jnp.asarray(np.random.default_rng(2).integers(
        0, pair.jcfg.vocab_size, (2, 9)))
    _, jcache = j_prefill(pair.jp, {"tokens": toks}, pair.jcfg, pad_to=16)
    jnp_cache = jax.tree.map(np.asarray, jcache)
    tcache = cache_from_jax(jnp_cache, "cpu")
    assert len(tcache["layers"]) == pair.tcfg.n_layers
    assert tcache["layers"][0][0].shape == jnp_cache["layers"][0].shape[1:]
    back = cache_to_jax(tcache)["layers"]
    for a, b in zip(back, jnp_cache["layers"]):
        np.testing.assert_array_equal(a, b)
    _, tcache2 = t_prefill(pair.tp, {"tokens": torch.as_tensor(
        np.array(toks))}, pair.tcfg, pad_to=16)
    np.testing.assert_allclose(cache_to_jax(tcache2)["layers"][0],
                               jnp_cache["layers"][0], atol=1e-5, rtol=0)


def test_bf16_cache_bridges_exactly():
    pools = t_kv.init_paged_pools(t_configs.smoke_config("stablelm-1.6b"), 3,
                                  4, device="cpu")
    pools["layers"][1][0].normal_(generator=torch.Generator().manual_seed(0))
    back = cache_to_jax(pools)["layers"][0]
    assert back.dtype.name == "bfloat16"
    again = cache_from_jax({"layers": (back, back)}, "cpu")
    assert torch.equal(again["layers"][1][0], pools["layers"][1][0])


# ------------------------------------------------------------------ #
# BlockAllocator and hash chains: the same operations, the same state
# ------------------------------------------------------------------ #
def _alloc_state(a):
    return (list(a._free), list(a._ref), list(a._hash), dict(a._by_hash),
            list(a._cached.items()), a.n_free, a.n_cached, a.in_use,
            a.available(), (a.stats.allocated, a.stats.evictions,
                            a.stats.cow_copies, a.stats.peak_in_use))


def test_allocator_replays_jax_op_for_op():
    rng = np.random.default_rng(0)
    ja, ta = j_kv.BlockAllocator(9, 4), t_kv.BlockAllocator(9, 4)
    live, hashes = [], [101, 102, 103, 104]
    for _ in range(300):
        op = rng.choice(["alloc", "alloc", "retain", "free", "free",
                         "register", "lookup", "peek", "cow"])
        if op == "alloc":
            got = (ja.alloc(), ta.alloc())
            assert got[0] == got[1]
            if got[0] is not None:
                live.append(got[0])
        elif op in ("retain", "free", "register", "cow") and live:
            bid = live[int(rng.integers(len(live)))]
            if op == "retain":
                ja.retain(bid), ta.retain(bid)
                live.append(bid)
            elif op == "free":
                ja.free(bid), ta.free(bid)
                live.remove(bid)
            elif op == "register":
                h = hashes[int(rng.integers(len(hashes)))]
                ja.register(bid, h), ta.register(bid, h)
            else:
                try:
                    got = ja.ensure_writable(bid)
                except MemoryError:
                    with pytest.raises(MemoryError):
                        ta.ensure_writable(bid)
                    continue
                assert ta.ensure_writable(bid) == got
                if got[1]:
                    live.remove(bid)
                    live.append(got[0])
        elif op in ("lookup", "peek"):
            h = hashes[int(rng.integers(len(hashes)))]
            got = (getattr(ja, op)(h), getattr(ta, op)(h))
            assert got[0] == got[1]
            if op == "lookup" and got[0] is not None:
                live.append(got[0])
        assert _alloc_state(ta) == _alloc_state(ja)
    ja.reset(), ta.reset()
    assert _alloc_state(ta) == _alloc_state(ja)


def test_hash_chains_match_jax():
    toks = np.random.default_rng(1).integers(0, 1000, 37).tolist()
    for bs in (4, 8, 16):
        assert t_kv.hash_prompt_blocks(toks, bs) == j_kv.hash_prompt_blocks(
            toks, bs)
        assert t_kv.hash_prompt_blocks(toks, bs, salt=3) == \
            j_kv.hash_prompt_blocks(toks, bs, salt=3)
    h1 = t_kv.hash_prompt_blocks([1, 2, 3, 4, 5, 6, 7, 8], 4)
    h2 = t_kv.hash_prompt_blocks([1, 2, 3, 4, 9, 9, 9, 9], 4)
    assert h1[0] == h2[0] and h1[1] != h2[1]


def _check_invariants(a, live):
    free, cached, owned = set(a._free), set(a._cached.values()), set(live)
    assert 0 not in owned
    assert len(free) == a.n_free and len(cached) == a.n_cached
    assert free | cached | owned == set(range(1, a.n_blocks))
    assert not (free & cached) and not (free & owned) and not (cached & owned)
    assert a.n_free + a.n_cached + a.in_use == a.usable_blocks
    for bid in range(1, a.n_blocks):
        assert a.refcount(bid) == live.get(bid, 0), bid
    for h, bid in a._by_hash.items():
        assert a._hash[bid] == h


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 40), n_blocks=st.integers(3, 24),
       n_ops=st.integers(40, 160))
def test_port_allocator_conservation(seed, n_blocks, n_ops):
    """The JAX allocator's conservation property, rerun on the port:
    random alloc/retain/free/register/lookup/peek/CoW interleavings keep
    refcounts, the free/cached/live partition and the trash block."""
    import random

    rng = random.Random(seed)
    a = t_kv.BlockAllocator(n_blocks, 4)
    live, issued = {}, []
    next_hash = iter(range(10_000, 10_000 + n_ops))
    for _ in range(n_ops):
        op = rng.choice(["alloc", "alloc", "retain", "free", "free",
                         "register", "lookup", "peek", "cow"])
        if op == "alloc":
            before = a.available()
            bid = a.alloc()
            if bid is None:
                assert before == 0
            else:
                assert bid not in live and bid != 0
                live[bid] = 1
        elif op == "retain" and live:
            bid = rng.choice(sorted(live))
            a.retain(bid)
            live[bid] += 1
        elif op == "free" and live:
            bid = rng.choice(sorted(live))
            a.free(bid)
            live[bid] -= 1
            if not live[bid]:
                del live[bid]
        elif op == "register" and live:
            bid = rng.choice(sorted(live))
            if issued and rng.random() < 0.3:
                h = rng.choice(issued)
            else:
                h = next(next_hash)
                issued.append(h)
            a.register(bid, h)
        elif op == "lookup" and issued:
            bid = a.lookup(rng.choice(issued))
            if bid is not None:
                live[bid] = live.get(bid, 0) + 1
        elif op == "peek" and issued:
            snap = (a.n_free, a.n_cached, a.in_use, list(a._ref))
            a.peek(rng.choice(issued))
            assert snap == (a.n_free, a.n_cached, a.in_use, list(a._ref))
        elif op == "cow" and live:
            bid = rng.choice(sorted(live))
            shared = live[bid] > 1 or a._hash[bid] is not None
            try:
                new, copied = a.ensure_writable(bid)
            except MemoryError:
                assert a.available() == 0
                continue
            assert copied == shared
            if copied:
                live[bid] -= 1
                if not live[bid]:
                    del live[bid]
                live[new] = 1
        _check_invariants(a, live)
    for bid, n in list(live.items()):
        for _ in range(n):
            a.free(bid)
    _check_invariants(a, {})


# ------------------------------------------------------------------ #
# PagedKVCache pools
# ------------------------------------------------------------------ #
def test_scatter_and_release_match_jax(pair):
    jcfg, tcfg = pair.jcfg, pair.tcfg
    jkv = j_kv.PagedKVCache(jcfg, n_slots=2, n_blocks=10, block_size=4,
                            max_blocks_per_seq=6)
    tkv = t_kv.PagedKVCache(tcfg, n_slots=2, n_blocks=10, block_size=4,
                            max_blocks_per_seq=6, device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (1, 10))
    _, dense = j_prefill(pair.jp, {"tokens": jnp.asarray(toks)}, jcfg,
                         pad_to=16)
    assert jkv.scatter_prefill(0, dense, 10) == tkv.scatter_prefill(
        0, cache_from_jax(jax.tree.map(np.asarray, dense), "cpu"), 10)
    assert tkv.grow(1) and jkv.grow(1)
    np.testing.assert_array_equal(tkv.tables.numpy(), np.asarray(jkv.tables))
    np.testing.assert_array_equal(cache_to_jax(tkv.pools)["layers"][0],
                                  np.asarray(jkv.pools["layers"][0]))
    tkv.release_slot(1), jkv.release_slot(1)
    np.testing.assert_array_equal(tkv.tables.numpy(), np.asarray(jkv.tables))
    assert _alloc_state(tkv.alloc) == _alloc_state(jkv.alloc)
    assert tkv.bytes_per_block == jkv.bytes_per_block
    assert tkv.bytes_per_token == t_kv.kv_bytes_per_token(tcfg) * \
        tcfg.n_layers


def test_make_writable_copies_block(pair):
    tkv = t_kv.PagedKVCache(pair.tcfg, n_slots=2, n_blocks=8, block_size=4,
                            max_blocks_per_seq=4, device="cpu")
    assert tkv.grow(0)
    bid = tkv.slot_blocks[0][0]
    tkv.pools["layers"][0][0][bid].fill_(3.0)
    tkv.alloc.retain(bid)                  # shared with slot 1
    tkv.slot_blocks[1] = [bid]
    tkv.make_writable(0, 0)
    new = tkv.slot_blocks[0][0]
    assert new != bid and tkv.slot_blocks[1] == [bid]
    assert (tkv.pools["layers"][0][0][new] == 3.0).all()
    assert int(tkv.tables[0, 0]) == new


def test_sizing_helpers_match_jax():
    for arch in ARCHS:
        for over in ({}, {"dtype": "float32"}, {"kv_cache_int8": True},
                     {"kv_cache_precision": "int4"}):
            jcfg = j_configs.smoke_config(arch).with_overrides(**over)
            tcfg = t_configs.smoke_config(arch).with_overrides(**over)
            assert t_kv.kv_bytes_per_token(tcfg) == j_kv.kv_bytes_per_token(
                jcfg)
            assert t_kv.kv_bytes_per_block(tcfg, 16) == \
                j_kv.kv_bytes_per_block(jcfg, 16)
            for budget in (0, 10**6, 10**9):
                assert t_kv.blocks_for_budget(tcfg, 16, budget) == \
                    j_kv.blocks_for_budget(jcfg, 16, budget)


def test_unported_pools_name_the_roadmap():
    cfg = t_configs.smoke_config("mistral-nemo-12b")
    # codebooks are served (item 9), in the dense cache only, as in JAX
    with pytest.raises(ValueError, match="multi-codebook"):
        t_kv.init_paged_pools(cfg.with_overrides(n_codebooks=2), 4, 4,
                              device="cpu")
    # the int4 pools are served: packed codes and f16 group scales
    int4 = t_kv.init_paged_pools(
        cfg.with_overrides(kv_cache_precision="int4"), 4, 4, device="cpu")
    assert [t.dtype for t in int4["layers"][0]] == [
        torch.int8, torch.float16, torch.int8, torch.float16]
    # a shared store (item 11) is served: both caches hold its pools
    store = t_kv.SharedKVPool(cfg, 4, 4, "cpu")
    a = t_kv.PagedKVCache(cfg, 1, 4, 4, 2, device="cpu", shared=store)
    b = t_kv.PagedKVCache(cfg, 1, 4, 4, 2, device="cpu", shared=store)
    assert a.pools is b.pools is store.pools and a.alloc is b.alloc
    with pytest.raises(ValueError, match="incompatible"):
        t_kv.PagedKVCache(cfg.with_overrides(kv_cache_precision="int8"), 1,
                          4, 4, 2, device="cpu", shared=store)
    assert t_kv.paged_supported(cfg) is None
    assert t_kv.paged_supported(cfg.with_overrides(window=8)) is not None
