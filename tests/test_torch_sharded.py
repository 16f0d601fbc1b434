"""Tensor-parallel serving in the port (``repro_torch.serving.sharded``,
``repro_torch.models.sharding``) against the JAX package's device-free
functions: the support gate, the local config, the fused-MLP permutation,
which dim of each param and cache leaf shards, the per-shard KV
accounting; the wo-site combine over a two-shard group on the CPU in both
modes; psum against exact logits; the group's failure and timeout paths;
exact launch counts under shard threads. The engines' streams are in
``test_torch_sharded_engines.py``."""
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import sharding as j_sharding  # noqa: E402
from repro.serving import kvcache as j_kv  # noqa: E402
from repro.serving import sharded as j_sharded  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import init_cache as t_init_cache  # noqa: E402
from repro_torch.models import sharding as t_sharding  # noqa: E402
from repro_torch.models.layers import linear, row_combine  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine  # noqa: E402
from repro_torch.serving import kvcache as t_kv  # noqa: E402
from repro_torch.serving import sharded as t_sharded  # noqa: E402
from repro_torch.tree import (leaves_with_path,  # noqa: E402
                              map_with_path)

#: the JAX file's smoke configs: mistral-nemo-12b in f32, and deepseek-v2's
#: MLA attention with its experts off (TP shards dense stacks only)
GQA = ("mistral-nemo-12b", {"dtype": "float32"})
MLA = ("deepseek-v2-236b", {"n_experts": 0, "dtype": "float32"})


def _cfgs(arch, **over):
    return (j_configs.smoke_config(arch).with_overrides(**over),
            t_configs.smoke_config(arch).with_overrides(**over))


@pytest.fixture(scope="module")
def gqa():
    jc, tc = _cfgs(GQA[0], **GQA[1])
    jp = j_init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")


@pytest.fixture(scope="module")
def mla():
    jc, tc = _cfgs(MLA[0], **MLA[1])
    jp = j_init(jax.random.PRNGKey(1), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")


# --------------------------------------------------------------------- #
# Support gate, local config (device-free)
# --------------------------------------------------------------------- #
GATE_CASES = [
    ("mistral-nemo-12b", {}, 1), ("mistral-nemo-12b", {}, 2),
    ("mistral-nemo-12b", {}, 3), ("mistral-nemo-12b", {}, 4),
    ("mistral-nemo-12b", {"n_kv_heads": 1}, 2),
    ("mistral-nemo-12b", {"window": 16}, 2),
    ("mistral-nemo-12b", {"d_ff": 255}, 2),
    ("mistral-nemo-12b", {"kv_cache_precision": "int4"}, 2),
    ("deepseek-v2-236b", {}, 2), ("deepseek-v2-236b", {"n_experts": 0}, 2),
    ("deepseek-v2-236b", {"n_experts": 0}, 4),
    ("recurrentgemma-9b", {}, 2), ("mamba2-780m", {}, 2),
    ("musicgen-large", {}, 2), ("phi-3-vision-4.2b", {}, 2),
    ("stablelm-1.6b", {}, 2), ("kimi-k2-1t-a32b", {}, 2)]


@pytest.mark.parametrize("arch,over,tp", GATE_CASES,
                         ids=[f"{a}-{'-'.join(o) or 'base'}-tp{t}"
                              for a, o, t in GATE_CASES])
def test_tp_unsupported_reason_matches_jax(arch, over, tp):
    jc, tc = _cfgs(arch, **over)
    want = j_sharded.tp_unsupported_reason(jc, tp)
    assert t_sharded.tp_unsupported_reason(tc, tp) == want
    # quantized *weights* are refused, quantized KV tiers are not
    fake = {"layers": [{"mlp": {"wi": {"w_int8": 1, "scale": 2}}}]}
    assert t_sharded.tp_unsupported_reason(tc, tp, fake) == \
        j_sharded.tp_unsupported_reason(jc, tp, fake)


@pytest.mark.parametrize("arch,over,tp", [(*GQA, 2), (*GQA, 4), (*MLA, 2),
                                          (*MLA, 4), ("stablelm-1.6b", {}, 2)])
def test_tp_local_config_matches_jax(arch, over, tp):
    jc, tc = _cfgs(arch, **over)
    jl, tl = j_sharded.tp_local_config(jc, tp), t_sharded.tp_local_config(
        tc, tp)
    for f in ("n_heads", "n_kv_heads", "head_dim", "d_ff", "kv_lora_rank",
              "qk_rope_dim", "v_head_dim", "d_model"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.resolved_head_dim == jl.resolved_head_dim == \
        tc.resolved_head_dim


def test_tp_region_refuses_an_unknown_combine():
    with pytest.raises(ValueError) as want:
        with j_sharding.tp_region(2, "ring"):
            pass
    with pytest.raises(ValueError) as got:
        with t_sharding.tp_region(2, "ring"):
            pass
    assert str(got.value) == str(want.value)
    assert t_sharding.tp_state() is None
    with t_sharding.tp_region(2, "psum", rank=1):
        st = t_sharding.tp_state()
        assert (st.tp, st.combine, st.rank) == (2, "psum", 1)
    assert t_sharding.tp_state() is None


def test_tp_context_refuses_moe_with_jax_message():
    jmoe, tmoe = _cfgs("deepseek-v2-236b")
    with pytest.raises(ValueError) as want:
        j_sharded.TPContext(jmoe, 2)
    with pytest.raises(ValueError) as got:
        t_sharded.TPContext(tmoe, 2, devices=["cpu", "cpu"])
    assert str(got.value) == str(want.value) and "MoE" in str(got.value)
    with pytest.raises(ValueError, match="3 shard devices for tp=2"):
        t_sharded.TPContext(_cfgs(*GQA[:1], **GQA[1])[1], 2,
                            devices=["cpu"] * 3)


# --------------------------------------------------------------------- #
# The fused-MLP permutation
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("two_ff,tp", [(8, 2), (16, 4), (24, 3), (512, 2),
                                       (512, 4), (28672, 2), (28672, 8)])
def test_wi_permutation_matches_jax(two_ff, tp):
    np.testing.assert_array_equal(
        t_sharded._wi_permutation(two_ff, tp).numpy(),
        j_sharded._wi_permutation(two_ff, tp))


@pytest.mark.parametrize("tp", [2, 4])
def test_permute_wi_for_tp_bit_for_bit(gqa, tp):
    jc, tc, jp, tp_params = gqa
    jperm = j_sharded.permute_wi_for_tp(jp, tp)
    tperm = t_sharded.permute_wi_for_tp(tp_params, tp)
    for i, layer in enumerate(tperm["layers"]):
        np.testing.assert_array_equal(
            layer["mlp"]["wi"].numpy(),
            np.asarray(jperm["layers"]["mlp"]["wi"][i]))
        # only mlp/wi leaves move; attention weights are the same tensors
        assert layer["attn"]["wq"] is tp_params["layers"][i]["attn"]["wq"]
        assert layer["mlp"]["wo"] is tp_params["layers"][i]["mlp"]["wo"]
    # a rank's view is its chunk of the permuted columns, and is what
    # TPContext.shard_params hands that shard (where tp divides the kv
    # heads: the smoke config has 2)
    shards = None
    if t_sharded.tp_unsupported_reason(tc, tp) is None:
        shards = t_sharded.TPContext(tc, tp, params=tp_params,
                                     devices=["cpu"] * tp).shard_params(
                                         tp_params)
    for rank in range(tp):
        mine = t_sharded.permute_wi_for_tp(tp_params, tp, rank)
        for i, layer in enumerate(mine["layers"]):
            full = np.asarray(jperm["layers"]["mlp"]["wi"][i])
            cols = full.shape[-1] // tp
            np.testing.assert_array_equal(
                layer["mlp"]["wi"].numpy(),
                full[..., rank * cols:(rank + 1) * cols])
            if shards is not None:
                assert torch.equal(shards[rank]["layers"][i]["mlp"]["wi"],
                                   layer["mlp"]["wi"])


@pytest.mark.parametrize("side", ["torch", "jax"])
@pytest.mark.parametrize("width", ["smoke", "k5120"])
def test_wi_permutation_keeps_gate_up_split(gqa, side, width):
    """Each shard's wi column slice is [gate_s | up_s]: the swiglu front
    half run per shard on its permuted slice and concatenated in shard
    order is the unsharded one. The permuted columns equal JAX's bit for
    bit; the per-shard GEMMs may round otherwise than the full GEMM (a
    slice of columns is another GEMM, which XLA:CPU sums apart at the
    smoke K of 128), so the gate / up columns are held within the rounding
    bound of two f32 K-term dot products in any order, K * eps * (|x| @
    |W|), here and at K 5120, and the front half within that bound carried
    through silu(g) * u plus one rounding of its own."""
    jc, tc, jp, tparams = gqa
    tp = 2
    if width == "smoke":
        wi = np.asarray(jp["layers"]["mlp"]["wi"][0])      # [d, 2ff]
    else:
        wi = np.random.default_rng(3).standard_normal(
            (5120, 1024)).astype(np.float32) / np.float32(np.sqrt(5120))
    x = np.random.default_rng(2).standard_normal(
        (3, wi.shape[0])).astype(np.float32)
    perm = t_sharded._wi_permutation(wi.shape[1], tp).numpy()
    np.testing.assert_array_equal(perm, j_sharded._wi_permutation(
        wi.shape[1], tp))
    pwi = wi[:, perm]
    if side == "torch":
        mm = lambda a, b: torch.matmul(torch.from_numpy(a),  # noqa: E731
                                       torch.from_numpy(np.array(b))).numpy()
        silu = lambda a: torch.nn.functional.silu(  # noqa: E731
            torch.from_numpy(a)).numpy()
    else:
        mm = lambda a, b: np.asarray(jnp.asarray(a) @ jnp.asarray(b))  # noqa: E731
        silu = lambda a: np.asarray(jax.nn.silu(jnp.asarray(a)))  # noqa: E731
    g, u = np.split(mm(x, wi), 2, axis=-1)
    ref = silu(g) * u
    cols = pwi.shape[-1] // tp
    eps = np.finfo(np.float32).eps
    bound_gu = wi.shape[0] * eps * (np.abs(x).astype(np.float64)
                                    @ np.abs(wi))
    bg, bu = np.split(bound_gu, 2, axis=-1)
    parts, gs, us = [], [], []
    for s in range(tp):
        g_s, u_s = np.split(mm(x, pwi[:, s * cols:(s + 1) * cols]), 2,
                            axis=-1)
        gs.append(g_s)
        us.append(u_s)
        parts.append(silu(g_s) * u_s)
    g2, u2 = np.concatenate(gs, -1), np.concatenate(us, -1)
    assert (np.abs(g2 - g) <= bg).all() and (np.abs(u2 - u) <= bu).all()
    # d(silu(g) u) = silu'(g) u dg + silu(g) du; |silu'| <= 1.1
    got = np.concatenate(parts, axis=-1)
    bound = 1.1 * np.abs(u) * bg + np.abs(silu(g)) * bu + eps * np.abs(ref)
    assert (np.abs(got - ref) <= bound + 1e-30).all()
    # the naive contiguous chunks (no permutation) break the split
    naive = np.concatenate([silu(a) * b for a, b in (
        np.split(mm(x, wi[:, s * cols:(s + 1) * cols]), 2, axis=-1)
        for s in range(tp))], axis=-1)
    assert not (np.abs(naive - ref) <= bound + 1e-30).all()


# --------------------------------------------------------------------- #
# Which dim of a leaf shards: JAX's rules on the same paths
# --------------------------------------------------------------------- #
def _jax_dim(spec):
    dims = [i for i, e in enumerate(spec) if e == "model"]
    return dims[0] if dims else None


@pytest.mark.parametrize("combine", ["exact", "psum"])
@pytest.mark.parametrize("which", ["gqa", "mla"])
@pytest.mark.parametrize("tp", [2, 4, 3])
def test_tp_param_spec_matches_jax(request, which, combine, tp):
    """The port's per-layer leaf ``layers/i/attn/wq`` [d, N] against JAX's
    stacked ``layers/attn/wq`` [L, d, N]: the same dim shards, one lower.
    A duck mesh of ``tp`` on "model" is all ``checked_spec`` reads (a real
    two-device mesh cannot be built here)."""
    jc, tc, jp, tparams = request.getfixturevalue(which)
    mesh = types.SimpleNamespace(shape={"model": tp})
    n = 0
    for path, leaf in leaves_with_path(tparams):
        keys = path.split("/")
        stacked = keys[0] == "layers"
        jpath = "/".join([keys[0]] + keys[2:]) if stacked else path
        jshape = ((jc.n_layers,) if stacked else ()) + tuple(leaf.shape)
        want = _jax_dim(j_sharding.tp_param_spec(jpath, jshape, mesh,
                                                 combine))
        got = t_sharding.tp_param_spec(path, tuple(leaf.shape), tp, combine)
        assert got == (None if want is None else want - stacked), path
        n += got is not None
    assert n > 0 or tp == 3


@pytest.mark.parametrize("tier", ["fp", "int8", "int4", "mla"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_cache_spec_matches_jax(gqa, mla, tier, tp):
    """Dense caches [B, S, Hkv, ...] and pools [N, bs, Hkv, ...] (and the
    scale rows) against JAX's stacked [L, ...] leaves."""
    if tier == "mla":
        jc, tc = mla[0], mla[1]
    else:
        jc = gqa[0].with_overrides(kv_cache_precision=tier)
        tc = gqa[1].with_overrides(kv_cache_precision=tier)
    mesh = types.SimpleNamespace(shape={"model": tp})
    pairs = [(jax.eval_shape(lambda: j_init_cache(jc, 2, 32)),
              t_init_cache(tc, 2, 32, device="cpu")),
             (jax.eval_shape(lambda: j_kv.init_paged_pools(jc, 9, 16)),
              t_kv.init_paged_pools(tc, 9, 16, device="cpu"))]
    for jtree, ttree in pairs:
        for jleaf, tleaf in zip(jtree["layers"], ttree["layers"][0]):
            want = _jax_dim(j_sharding.tp_cache_spec(jc, jleaf.shape, mesh))
            got = t_sharding.tp_cache_spec(tc, tuple(tleaf.shape), tp)
            assert got == (None if want is None else want - 1)
            assert (got is None) == (tier == "mla" or tc.n_kv_heads % tp > 0)


# --------------------------------------------------------------------- #
# Per-shard KV accounting (device-free)
# --------------------------------------------------------------------- #
ACCOUNTING = [(*GQA, "fp"), (*GQA, "int8"), (*GQA, "int4"), (*MLA, "fp"),
              ("mistral-nemo-12b", {"n_kv_heads": 1, "dtype": "float32"},
               "fp"), ("stablelm-1.6b", {}, "int4")]


@pytest.mark.parametrize("arch,over,tier", ACCOUNTING)
def test_kv_accounting_matches_jax(arch, over, tier):
    jc, tc = _cfgs(arch, kv_cache_precision=tier, **over)
    for shards in (1, 2, 4):
        assert t_kv.kv_shard_divisor(tc, shards) == \
            j_kv.kv_shard_divisor(jc, shards)
        assert t_kv.kv_bytes_per_token(tc, shards=shards) == \
            j_kv.kv_bytes_per_token(jc, shards=shards)
        for bs in (8, 16):
            assert t_kv.kv_bytes_per_block(tc, bs, shards=shards) == \
                j_kv.kv_bytes_per_block(jc, bs, shards=shards)
            for budget in (0, 10**5, 7 * 10**6):
                assert t_kv.blocks_for_budget(tc, bs, budget,
                                              shards=shards) == \
                    j_kv.blocks_for_budget(jc, bs, budget, shards=shards)
    if tc.attention == "mla" or tc.n_kv_heads % 2:
        assert t_kv.kv_shard_divisor(tc, 2) == 1
    else:
        assert t_kv.kv_bytes_per_token(tc, shards=2) * 2 == \
            t_kv.kv_bytes_per_token(tc)


@pytest.mark.parametrize("which", ["gqa", "mla"])
def test_pool_bytes_per_shard(request, which):
    """A tp=2 engine's pool: each shard holds half of every GQA block (the
    whole of an MLA block), and the global bytes are tp=1's."""
    jc, tc, _, tparams = request.getfixturevalue(which)
    kw = dict(n_slots=2, max_len=64, paged=True, device="cpu")
    e1 = ContinuousBatchingEngine(tparams, tc, **kw)
    e2 = ContinuousBatchingEngine(tparams, tc, tp=2, **kw)
    assert e2.kv.bytes_per_block == e1.kv.bytes_per_block
    div = 1 if which == "mla" else 2
    assert e2.kv.bytes_per_block_per_shard * div == e1.kv.bytes_per_block
    assert e2.kv.kv_bytes_in_use_per_shard(3) * div == \
        e1.kv.kv_bytes_in_use(3)
    assert len(e1.kv.shard_pools) == 1 and e1.cache is e1.kv.shard_pools
    assert len(e2.kv.shard_pools) == 2 and e2.cache is e2.kv.shard_pools
    assert e2.kv.pools is e2.kv.shard_pools[0]
    shapes = [[tuple(t.shape) for t in leaves]
              for leaves in e2.kv.shard_pools[1]["layers"]]
    assert shapes == [[tuple(t.shape) for t in leaves]
                      for leaves in e2.kv.shard_pools[0]["layers"]]


@pytest.mark.parametrize("which", ["gqa", "mla"])
def test_scatter_prefill_splits_as_the_pools(request, which):
    """A sharded store takes the whole dense prefill cache, as the JAX
    store does: each shard's blocks then hold that shard's slice of what an
    unsharded store's blocks hold (GQA's kv heads, MLA's whole latents)."""
    _, tc, _, tparams = request.getfixturevalue(which)
    ctx = t_sharded.TPContext(tc, 2, params=tparams, devices=["cpu", "cpu"])
    kw = dict(n_blocks=9, block_size=8, max_blocks_per_seq=4, device="cpu")
    one = t_kv.PagedKVCache(tc, 2, **kw)
    two = t_kv.PagedKVCache(tc, 2, shards=2, pool_sharding=ctx.shard_cache,
                            **kw)
    gen = torch.Generator().manual_seed(3)
    dense = map_with_path(
        lambda path, leaf: torch.randn(leaf.shape, generator=gen).to(
            leaf.dtype), t_init_cache(tc, 1, 32, device="cpu"))
    assert one.scatter_prefill(1, dense, 20) == two.scatter_prefill(
        1, dense, 20)
    for want, got in zip(ctx.shard_cache(one.pools), two.shard_pools):
        for (path, w), (_, g) in zip(leaves_with_path(want),
                                     leaves_with_path(got)):
            assert torch.equal(w, g), path


# --------------------------------------------------------------------- #
# The combine over a two-shard group
# --------------------------------------------------------------------- #
def test_row_combine_exact_and_psum_against_linear():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((3, 5, 64), generator=gen)
    wo = torch.randn((64, 24), generator=gen) / 8
    want = linear(wo, x)
    assert torch.equal(row_combine(wo, x), want)     # outside a region
    for combine in ("exact", "psum"):
        group = t_sharding.ShardGroup(["cpu", "cpu"], combine)
        try:
            def body(r):
                xs = x[..., r * 32:(r + 1) * 32]
                w = wo if combine == "exact" else wo[r * 32:(r + 1) * 32]
                return row_combine(w, xs)

            outs = group.run(body)
        finally:
            group.close()
        assert torch.equal(outs[0], outs[1])     # every rank the same bits
        if combine == "exact":
            assert torch.equal(outs[0], want)    # the tp=1 contraction
        else:
            torch.testing.assert_close(outs[0], want, rtol=1e-6, atol=1e-6)
            assert torch.equal(outs[0], linear(wo[:32], x[..., :32])
                               + linear(wo[32:], x[..., 32:]))


def test_shard_group_keeps_grad_mode_and_devices():
    group = t_sharding.ShardGroup(["cpu", "cpu"])
    try:
        with torch.no_grad():
            modes = group.run(lambda r: (torch.is_grad_enabled(),
                                         t_sharding.tp_state().rank))
        assert modes == [(False, 0), (False, 1)]
        with torch.inference_mode():
            assert group.run(lambda r: torch.is_inference_mode_enabled()) \
                == [True, True]
        assert group.run(lambda r: torch.is_grad_enabled()) == [True, True]
    finally:
        group.close()


def test_failed_shard_raises_within_the_timeout():
    """A shard that raises aborts the group its peer waits in: the run
    raises the shard's own error at once, and the group serves the next
    run. A shard that returns before a combine breaks it; one that keeps
    its turn past the timeout lets its peer's wait time out: the run
    raises, it does not hang."""
    group = t_sharding.ShardGroup(["cpu", "cpu"], timeout=30.0)
    try:
        def boom(r):
            if r == 1:
                raise KeyError("shard 1 lost a leaf")
            return group.all_gather(torch.ones(2), r)

        t0 = time.perf_counter()
        with pytest.raises(KeyError, match="shard 1 lost a leaf"):
            group.run(boom)
        assert time.perf_counter() - t0 < 10.0
        outs = group.run(lambda r: group.all_reduce(torch.full((2,), r + 1.0),
                                                    r))
        assert all(torch.equal(o, torch.full((2,), 3.0)) for o in outs)
    finally:
        group.close()
    short = t_sharding.ShardGroup(["cpu", "cpu"], timeout=0.5)
    try:
        # shard 1 returns before the combine shard 0 waits at
        t0 = time.perf_counter()
        with pytest.raises(threading.BrokenBarrierError, match="returned"):
            short.run(lambda r: r if r else short.all_gather(torch.ones(1), r))
        # shard 1 keeps its turn past the timeout
        def slow(r):
            if r:
                time.sleep(0.8)     # past the timeout, inside 2x
            return short.all_gather(torch.ones(1), r)

        with pytest.raises(threading.BrokenBarrierError, match="waited"):
            short.run(slow)
        assert time.perf_counter() - t0 < 10.0
        assert len(short.run(lambda r: short.all_gather(torch.ones(1), r))) \
            == 2
    finally:
        short.close()


def test_engine_raises_when_a_shard_fails(gqa):
    _, tc, _, tparams = gqa
    eng = ContinuousBatchingEngine(tparams, tc, n_slots=2, max_len=48,
                                   paged=True, tp=2, device="cpu")
    eng.submit(torch.arange(1, 9)[None])
    del eng.params[1]["layers"][1]["attn"]["wo"]
    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="wo"):
        eng.step()
    assert time.perf_counter() - t0 < 30.0


def test_launch_counts_exact_under_threads():
    """``_build.count`` under many threads and a short switch interval: a
    lost update would leave a count short."""
    fn = types.SimpleNamespace(launches=0, launches_by_body={"a": 0})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _build.count(fn, launches_by_body="a")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == fn.launches_by_body["a"] == 16 * 2000


# --------------------------------------------------------------------- #
# psum against exact; every rank's logits
# --------------------------------------------------------------------- #
def test_tp2_psum_combine_matches_logits(gqa):
    """The row-parallel combine's prefill logits agree with the exact
    combine's to 2e-5 (JAX's bound), the exact ones equal tp=1's, and rank
    1's returned logits are rank 0's bit for bit."""
    from repro_torch.models import prefill

    _, tc, _, tparams = gqa
    batch = {"tokens": (torch.arange(1, 13) % tc.vocab_size)[None]}
    got = {}
    for combine in ("exact", "psum"):
        ctx = t_sharded.TPContext(tc, 2, combine=combine, params=tparams,
                                  devices=["cpu", "cpu"])
        sp = ctx.shard_params(tparams)
        got[combine] = ctx.prefill_logits(sp, batch)
        lcfg = ctx.local_cfg
        outs = ctx.run_shards(lambda p, b: prefill(p, b, lcfg, pad_to=13),
                              sp, None, batch)
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][0], got[combine])
        ctx.group.close()
    with torch.no_grad():
        ref, _ = prefill(tparams, batch, tc, pad_to=13)
    assert torch.equal(got["exact"], ref)
    torch.testing.assert_close(got["psum"], got["exact"], rtol=2e-5,
                               atol=2e-5)


def test_shard_params_share_replicated_leaves(gqa):
    _, tc, _, tparams = gqa
    for combine in ("exact", "psum"):
        ctx = t_sharded.TPContext(tc, 2, combine=combine,
                                  devices=["cpu", "cpu"])
        s0, s1 = ctx.shard_params(tparams)
        ctx.group.close()
        assert s0["embed"] is s1["embed"] is tparams["embed"]
        wo0, wo1 = s0["layers"][0]["attn"]["wo"], s1["layers"][0]["attn"]["wo"]
        if combine == "exact":
            assert wo0 is wo1 is tparams["layers"][0]["attn"]["wo"]
        else:
            assert torch.equal(torch.cat([wo0, wo1]),
                               tparams["layers"][0]["attn"]["wo"])
        wq = tparams["layers"][0]["attn"]["wq"]
        assert s1["layers"][0]["attn"]["wq"].is_contiguous()
        assert torch.equal(torch.cat([s0["layers"][0]["attn"]["wq"],
                                      s1["layers"][0]["attn"]["wq"]], 1), wq)
        wi = t_sharded.permute_wi_for_tp(tparams, 2)["layers"][0]["mlp"]["wi"]
        assert torch.equal(torch.cat([s0["layers"][0]["mlp"]["wi"],
                                      s1["layers"][0]["mlp"]["wi"]], 1), wi)
