"""The port's int4 KV-cache tier against the JAX package: the wire layout and
quantizer bit for bit (edge groups included), the int4 plain versions
against the Pallas kernels (interpret mode) and JAX's dense oracle, the
trash-block isolation of the paged plain version, dense and paged prefill
+ decode on bridged weights, and greedy streams of the session and both
engines. The CUDA kernels are held against the plain versions in
test_torch_cuda.py."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.kernels import quantize as j_quant  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_prefill import flash_q4prefill_attention  # noqa: E402
from repro.kernels.paged_attn import paged_q4decode_attention  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import decode_step_paged as j_decode_paged  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import prefill_paged as j_prefill_paged  # noqa: E402
from repro.serving import kvcache as j_kv  # noqa: E402
from repro.serving.engine import InferenceSession as JSession  # noqa: E402
from repro.serving.scheduler import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import (cache_from_jax, cache_to_jax,  # noqa: E402
                                params_from_jax)
from repro_torch.kernels import flash_prefill, ops, paged_attn  # noqa: E402
from repro_torch.kernels import quantize as t_quant  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import decode_step_paged as t_decode_paged  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.models import prefill as t_prefill  # noqa: E402
from repro_torch.models import prefill_paged as t_prefill_paged  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 InferenceSession)
from repro_torch.serving import kvcache as t_kv  # noqa: E402

ARCHS = ["stablelm-1.6b", "mistral-nemo-12b"]
NEG_INF = -2.0e38
INT4KV = {"dtype": "float32", "kv_cache_precision": "int4"}
# the JAX model entry points, compiled whole (op-by-op dispatch compiles
# every primitive of the stack and takes four times as long here)
_jit = functools.partial(jax.jit, static_argnames=("cfg",))
j_prefill_jit = jax.jit(j_prefill, static_argnames=("cfg", "pad_to"))
j_decode_jit, j_prefill_paged_jit, j_decode_paged_jit = (
    _jit(j_decode), _jit(j_prefill_paged), _jit(j_decode_paged))


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


# ------------------------------------------------------------------ #
# The wire layout and the quantizer: bit for bit
# ------------------------------------------------------------------ #
def test_pack_unpack_match_jax_and_layout():
    codes = np.random.default_rng(0).integers(-8, 8, (5, 3, 64)).astype(
        np.int8)
    got = t_quant.pack_int4(torch.from_numpy(codes))
    want = np.asarray(j_quant.pack_int4(jnp.asarray(codes)))
    assert got.dtype == torch.int8 and got.shape == (5, 3, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_quant.unpack_int4(got).numpy(), codes)
    np.testing.assert_array_equal(
        t_quant.unpack_int4(got).numpy(),
        np.asarray(j_quant.unpack_int4(jnp.asarray(want))))
    # element d in byte d // 2, the even one in the low nibble
    byte = int(t_quant.pack_int4(torch.tensor([[3, -5]], dtype=torch.int8)))
    assert byte & 0xF == 3 and (byte >> 4) & 0xF == (-5) & 0xF
    assert t_quant.kv_group_size(16) == 16 == j_quant.kv_group_size(16)
    assert t_quant.kv_group_size(128) == 32 == j_quant.kv_group_size(128)


def _kv4_rows(hd, dtype):
    """[2, 3, 2, hd] K/V: a group of exact .5 quotients against a
    power-of-two scale, an all-zero group (0/0: codes 0), a group of
    absmax ~1e-9 (its f16 scale underflows to 0: codes +-7, scale 0) and
    random groups."""
    rng = np.random.default_rng(hd)
    t = rng.normal(size=(2, 3, 2, hd)).astype(np.float32) * 3
    g = min(32, hd)
    halves = np.resize(np.array([7, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                                 -3.5, 4.5, -6.5, 6.5, 0, 1, -7, 5.5],
                                np.float32), g)
    t[0, 0, 0, :g] = halves * 0.25           # scale 0.25 exactly in f16
    t[0, 1, 1, :g] = 0
    t[1, 2, 0, :g] = rng.normal(size=g) * 1e-9
    t[1, 0, 1, :g] = halves * 8
    if dtype == "bfloat16":
        import ml_dtypes

        return t.astype(ml_dtypes.bfloat16)
    return t


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_int4_matches_jax_bit_for_bit(hd, dtype):
    t = _kv4_rows(hd, dtype)
    tt = torch.from_numpy(t.astype(np.float32))
    if dtype == "bfloat16":
        tt = tt.to(torch.bfloat16)
    got_q, got_s = t_quant.quantize_kv_int4(tt)
    g = min(32, hd)
    assert got_q.dtype == torch.int8 and got_q.shape == t.shape[:-1] + (
        hd // 2,)
    assert got_s.dtype == torch.float16 and got_s.shape == t.shape[:-1] + (
        hd // g,)
    codes = t_quant.unpack_int4(got_q)
    assert codes[0, 0, 0, :8].tolist() == [7, 0, 2, 2, 0, -2, -2, 4]
    assert (codes[0, 1, 1, :g] == 0).all() and float(got_s[0, 1, 1, 0]) == 0
    assert float(got_s[1, 2, 0, 0]) == 0
    assert set(codes[1, 2, 0, :g].abs().tolist()) == {7}
    for want_q, want_s in (j_quant.quantize_kv_int4(jnp.asarray(t)),
                           j_ref.quantize_kv4_ref(jnp.asarray(t))):
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    rq, rs = t_ref.quantize_kv4_ref(tt)
    assert torch.equal(rq, got_q) and torch.equal(rs, got_s)
    np.testing.assert_array_equal(
        t_quant.dequantize_kv_int4(got_q, got_s).numpy(),
        np.asarray(j_quant.dequantize_kv_int4(jnp.asarray(got_q.numpy()),
                                              jnp.asarray(got_s.numpy()))))


# ------------------------------------------------------------------ #
# Plain versions against the Pallas kernels (interpret mode)
# ------------------------------------------------------------------ #
def _packed(rng, shape):
    """Random packed bytes: every nibble -8..7 (the layout, not only the
    quantizer's -7..7)."""
    return rng.integers(-128, 128, shape).astype(np.int8)


def _gscales(rng, shape):
    # f16 group scales of dequantized values of order 1, as int4 K/V are
    return (rng.uniform(0.5, 1.5, shape) / 7).astype(np.float16)


def _q4decode_case(seed, b, s, hkv, g, hd):
    rng = np.random.default_rng(seed)
    ng = hd // min(32, hd)
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    bias = np.zeros((b, s), np.float32)
    for i in range(b):                       # a masked tail after each pos
        bias[i, rng.integers(0, s):] = NEG_INF
        bias[i, 0] = 0.0
    return (q, _packed(rng, (b, s, hkv, hd // 2)),
            _gscales(rng, (b, s, hkv, ng)),
            _packed(rng, (b, s, hkv, hd // 2)),
            _gscales(rng, (b, s, hkv, ng)), bias)


@pytest.mark.parametrize("s", [1, 37, 128])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
def test_q4decode_ref_matches_jax(g, hd, s):
    case = _q4decode_case(g * hd + s, 3, s, 2, g, hd)
    want = np.asarray(jax.jit(j_ref.q4decode_ref)(*_j(*case)))
    got = t_ref.q4decode_ref(*_t(*case))
    assert got.dtype == torch.float32 and got.shape == case[0].shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _paged_q4_case(seed, b, hkv, g, hd, bs, m, pos, holes=()):
    """As test_torch_int8kv's case, over int4 pools with f16 group-scale
    pools."""
    rng = np.random.default_rng(seed)
    n = b * m + 3
    ng = hd // 32
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    pools = (_packed(rng, (n, bs, hkv, hd // 2)), _gscales(rng, (n, bs, hkv,
                                                                  ng)),
             _packed(rng, (n, bs, hkv, hd // 2)), _gscales(rng, (n, bs, hkv,
                                                                  ng)))
    ids = iter(rng.permutation(np.arange(1, n)))
    tables = np.full((b, m), -1, np.int32)
    for i, p in enumerate(pos):
        for j in range(p // bs + 1):
            tables[i, j] = next(ids)
    for i, j in holes:
        tables[i, j] = -1
    return (q, *pools, tables, np.asarray(pos, np.int32))


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_q4decode_ref_matches_pallas(g, hd, bs):
    pos = [0, 4 * bs - 1, 2 * bs, 3 * bs + 5]
    case = _paged_q4_case(g * hd + bs, 4, 2, g, hd, bs, 5, pos,
                          holes=[(3, 1)])
    want = np.asarray(paged_q4decode_attention(*_j(*case), interpret=True))
    got = t_ref.paged_q4decode_ref(*_t(*case))
    assert got.dtype == torch.float32 and got.shape == case[0].shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# (b, s, hq, hkv, hd, dv): the int8 file's shapes with dv a multiple of
# the group (JAX gives V as many scale groups as K: dv 16 beside hd 32)
@pytest.mark.parametrize("b,s,hq,hkv,hd,dv", [(1, 1, 4, 4, 32, 32),
                                              (2, 77, 4, 2, 32, 16),
                                              (1, 130, 8, 2, 64, 64),
                                              (1, 256, 4, 1, 16, 16)])
def test_flash_q4prefill_ref_matches_pallas(b, s, hq, hkv, hd, dv):
    rng = np.random.default_rng(s + hd)
    ng = hd // min(32, hd)
    q = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    case = (q, _packed(rng, (b, s, hkv, hd // 2)),
            _gscales(rng, (b, s, hkv, ng)),
            _packed(rng, (b, s, hkv, dv // 2)),
            _gscales(rng, (b, s, hkv, ng)))
    want = np.asarray(flash_q4prefill_attention(*_j(*case), interpret=True))
    got = t_ref.flash_q4prefill_ref(*_t(*case))
    assert got.shape == (b, s, hq, dv)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_paged_q4decode_idle_row_and_poisoned_trash_block():
    """An idle slot (table all -1, pos 0) is 0/0; NaN f16 scales and 0x88
    bytes (codes -8) in the trash block never reach a live row."""
    case = list(_paged_q4_case(3, 3, 2, 2, 64, 8, 4, [12, 0, 20],
                               holes=[(2, 1)]))
    case[5][1] = -1
    clean = t_ref.paged_q4decode_ref(*_t(*case)).numpy()
    assert np.isnan(clean[1]).all() and np.isfinite(clean[[0, 2]]).all()
    want = np.asarray(paged_q4decode_attention(*_j(*case), interpret=True))
    np.testing.assert_allclose(clean[[0, 2]], want[[0, 2]], atol=1e-5,
                               rtol=0)
    for pool in (1, 3):
        case[pool][0] = np.int8(-120)        # 0x88
    for pool in (2, 4):
        case[pool][0] = np.nan
    poisoned = t_ref.paged_q4decode_ref(*_t(*case)).numpy()
    np.testing.assert_array_equal(poisoned[[0, 2]], clean[[0, 2]])


def test_int4_wrappers_take_plain_versions_on_cpu_and_check_operands():
    pq = _t(*_paged_q4_case(2, 2, 2, 2, 32, 8, 3, [5, 17]))
    rng = np.random.default_rng(3)
    fq = _t(rng.normal(size=(1, 9, 4, 32)).astype(np.float32),
            _packed(rng, (1, 9, 2, 16)), _gscales(rng, (1, 9, 2, 1)),
            _packed(rng, (1, 9, 2, 16)), _gscales(rng, (1, 9, 2, 1)))
    counters = (paged_attn.paged_q4decode, flash_prefill.flash_q4prefill)
    before = [fn.launches for fn in counters]
    assert torch.equal(ops.paged_q4decode(*pq), t_ref.paged_q4decode_ref(*pq))
    assert torch.equal(ops.flash_q4prefill(*fq),
                       t_ref.flash_q4prefill_ref(*fq))
    assert [fn.launches for fn in counters] == before
    with pytest.raises(TypeError):            # f32 scale pools
        paged_attn.paged_q4decode(pq[0], pq[1], pq[2].float(), pq[3],
                                  pq[4].float(), *pq[5:])
    with pytest.raises(ValueError):           # unpacked width hd
        wide = torch.zeros(pq[1].shape[:3] + (32,), dtype=torch.int8)
        paged_attn.paged_q4decode(pq[0], wide, pq[2], wide, *pq[4:])
    with pytest.raises(ValueError):           # hd not a multiple of 32
        n, bs, hkv = pq[1].shape[:3]
        codes = torch.zeros(n, bs, hkv, 8, dtype=torch.int8)
        scales = torch.zeros(n, bs, hkv, 1, dtype=torch.float16)
        paged_attn.paged_q4decode(torch.zeros(2, 2, 2, 16), codes, scales,
                                  codes, scales, *pq[5:])
    with pytest.raises(TypeError):            # int64 tables
        paged_attn.paged_q4decode(*pq[:5], pq[5].long(), pq[6])
    with pytest.raises(ValueError):           # scales [B,S,Hkv,hd//32]
        flash_prefill.flash_q4prefill(*fq[:2], fq[2][..., :0], *fq[3:])
    with pytest.raises(TypeError):            # int8-tier f32 scales
        flash_prefill.flash_q4prefill(fq[0], fq[1], fq[2].float(), fq[3],
                                      fq[4].float())
    with pytest.raises(ValueError):           # non-contiguous q
        flash_prefill.flash_q4prefill(fq[0].transpose(1, 2).contiguous()
                                      .transpose(1, 2), *fq[1:])


# ------------------------------------------------------------------ #
# Models on bridged weights
# ------------------------------------------------------------------ #
class _Pair:
    def __init__(self, arch):
        self.jcfg = j_configs.smoke_config(arch).with_overrides(**INT4KV)
        self.tcfg = t_configs.smoke_config(arch).with_overrides(**INT4KV)
        jp = j_init(jax.random.PRNGKey(0), self.jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), self.tcfg, "cpu")
        self.params = {"fp32": (jp, tp)}
        self.params["dynamic_int8"] = (
            JSpec.dynamic_int8().build(jp, self.jcfg)[0],
            TSpec.dynamic_int8().build(tp, self.tcfg)[0])

    def engines(self, variant, **kw):
        jp, tp = self.params[variant]
        kw.setdefault("n_slots", 2)
        kw.setdefault("max_len", 64)
        return (JEngine(jp, self.jcfg, **kw),
                ContinuousBatchingEngine(tp, self.tcfg, device="cpu", **kw))


_PAIRS = {}


def _pair(arch):
    if arch not in _PAIRS:
        _PAIRS[arch] = _Pair(arch)
    return _PAIRS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def nemo():
    """The GQA smoke config (G = 2) for the engine and session runs."""
    return _pair("mistral-nemo-12b")


BS, N_BLOCKS = 4, 16
LENS = (10, 7)
TABLES = np.array([[9, 2, 14, 5, 11, -1], [3, 12, 7, 10, -1, -1]], np.int32)
N_STEPS = 6


def _assert_leaves_equal(got, want, written):
    """(k_q, k_scale, v_q, v_scale) equal at every written slot: packed
    codes byte for byte, f16 scales bit for bit."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g[:, written], w[:, written])


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_int4kv_prefill_decode_match_jax_dense_and_paged(pair, variant):
    jq, tq = pair.params[variant]
    jcfg, tcfg = pair.jcfg, pair.tcfg
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, (1, n)) for n in LENS]
    j_pools = j_kv.init_paged_pools(jcfg, N_BLOCKS, BS)
    t_pools = t_kv.init_paged_pools(tcfg, N_BLOCKS, BS, device="cpu")
    j_dense = [None, None]
    t_dense = init_cache(tcfg, 2, 32, device="cpu")
    last_tok = []
    for i, p in enumerate(prompts):
        padded = np.pad(p, ((0, 0), (0, 16 - p.shape[1])))    # token bucket
        jl, j_pools = j_prefill_paged_jit(
            jq, j_pools, {"tokens": jnp.asarray(padded)}, jnp.int32(LENS[i]),
            jnp.asarray(TABLES[i:i + 1]), cfg=jcfg)
        tl, _ = t_prefill_paged(tq, t_pools, {"tokens": torch.as_tensor(
            padded)}, LENS[i], torch.as_tensor(TABLES[i:i + 1]), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        jdl, j_dense[i] = j_prefill_jit(jq, {"tokens": jnp.asarray(p)},
                                        cfg=jcfg, pad_to=32)
        dl, single = t_prefill(tq, {"tokens": torch.as_tensor(p)}, tcfg,
                               pad_to=32)
        np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), atol=1e-4,
                                   rtol=0)
        for leaves, new in zip(t_dense["layers"], single["layers"]):
            for c, c1 in zip(leaves, new):
                c[i:i + 1] = c1
        np.testing.assert_allclose(tl.numpy(), dl.numpy(), atol=1e-5, rtol=0)
        last_tok.append(int(torch.argmax(tl[0, -1])))
    # the JAX dense cache of both sequences, batched as the port's
    j_cache = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=1),
                           *j_dense)
    tok = np.asarray(last_tok).reshape(2, 1)
    pos = np.asarray(LENS)
    tables_t = torch.as_tensor(TABLES)
    for _ in range(N_STEPS):
        jl, j_pools = j_decode_paged_jit(jq, j_pools, jnp.asarray(tok),
                                         jnp.asarray(pos, jnp.int32),
                                         jnp.asarray(TABLES), cfg=jcfg)
        jdl, j_cache = j_decode_jit(jq, j_cache, jnp.asarray(tok),
                                    jnp.asarray(pos, jnp.int32), cfg=jcfg)
        tl, _ = t_decode_paged(tq, t_pools, torch.as_tensor(tok),
                               torch.as_tensor(pos), tables_t, tcfg)
        dl, t_dense = t_decode(tq, t_dense, torch.as_tensor(tok),
                               torch.as_tensor(pos), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), atol=1e-4,
                                   rtol=0)
        # the twin of the JAX paged-vs-dense test: same port, two caches
        np.testing.assert_allclose(tl.numpy(), dl.numpy(), atol=1e-5, rtol=0)
        tok = torch.argmax(tl[:, -1], dim=-1).numpy().reshape(2, 1)
        pos = pos + 1
    # caches and pools bridged back: (k_q, k_scale, v_q, v_scale) leaves
    # equal JAX's at every written slot
    t_back = cache_to_jax(t_dense)["layers"]
    j_back = [np.asarray(a) for a in j_cache["layers"]]
    assert [a.shape for a in t_back] == [a.shape for a in j_back]
    assert [a.dtype for a in t_back] == [a.dtype for a in j_back]
    assert [str(a.dtype) for a in t_back] == ["int8", "float16"] * 2
    for i in range(2):
        row = lambda a, i=i: a[:, i]                    # noqa: E731
        _assert_leaves_equal([row(a) for a in t_back],
                             [row(a) for a in j_back], slice(0, int(pos[i])))
    tp_back = cache_to_jax(t_pools)["layers"]
    jp_back = [np.asarray(a) for a in j_pools["layers"]]
    for i in range(2):
        n = int(pos[i])
        blocks = TABLES[i, :-(-n // BS)]

        def flat(a, blocks=blocks):
            w = a[:, blocks]
            return w.reshape(w.shape[0], -1, *w.shape[3:])
        _assert_leaves_equal([flat(a) for a in tp_back],
                             [flat(a) for a in jp_back], slice(0, n))


def test_int4_cache_bridge_round_trips(pair):
    toks = jnp.asarray(np.random.default_rng(2).integers(
        0, pair.jcfg.vocab_size, (2, 9)))
    jp, _ = pair.params["fp32"]
    _, jcache = j_prefill(jp, {"tokens": toks}, pair.jcfg, pad_to=16)
    jnp_cache = jax.tree.map(np.asarray, jcache)
    tcache = cache_from_jax(jnp_cache, "cpu")
    assert len(tcache["layers"]) == pair.tcfg.n_layers
    assert [t.dtype for t in tcache["layers"][0]] == [
        torch.int8, torch.float16, torch.int8, torch.float16]
    for a, b in zip(cache_to_jax(tcache)["layers"], jnp_cache["layers"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ref = init_cache(pair.tcfg, 2, 16, device="cpu")["layers"][0]
    assert [t.shape for t in tcache["layers"][0]] == [t.shape for t in ref]
    assert [t.dtype for t in ref] == [t.dtype for t in tcache["layers"][0]]
    pools = t_kv.init_paged_pools(pair.tcfg, 5, 4, device="cpu")
    j_pools = jax.tree.map(np.asarray, j_kv.init_paged_pools(pair.jcfg, 5, 4))
    assert [(a.shape, a.dtype) for a in cache_to_jax(pools)["layers"]] == [
        (a.shape, a.dtype) for a in j_pools["layers"]]
    per_token = sum(t[0, 0].numel() * t.element_size()
                    for t in pools["layers"][0])
    assert per_token == t_kv.kv_bytes_per_token(pair.tcfg) \
        == j_kv.kv_bytes_per_token(pair.jcfg)


# ------------------------------------------------------------------ #
# Session and engines: greedy streams identical to JAX's
# ------------------------------------------------------------------ #
COUNTING = ("completed", "rejected", "cancelled", "submitted",
            "decode_steps", "generated_tokens", "prefill_tokens", "preempted",
            "prefix_hit_tokens", "prompt_tokens_computed", "kv_blocks_peak",
            "kv_hbm_bytes_per_req", "tp")


def _submit(engines, prompt, **kw):
    je, te = engines
    return (je.submit(jnp.asarray(prompt), **kw),
            te.submit(torch.as_tensor(prompt), **kw))


def _run_same(engines, prompts_kw):
    pairs = [_submit(engines, p, **kw) for p, kw in prompts_kw]
    for e in engines:
        e.run()
    je, te = engines
    for jr, tr in pairs:
        assert tr.done and tr.out_tokens == jr.out_tokens, tr.rid
        assert (tr.prefix_hit, tr.preemptions) == (jr.prefix_hit,
                                                   jr.preemptions)
    mj, mt = je.metrics(), te.metrics()
    assert {k: mt[k] for k in COUNTING} == {k: mj[k] for k in COUNTING}
    return [tr.out_tokens for _, tr in pairs], mt


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (1, n)) for n in lens]


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_int4kv_engine_streams_match_jax(nemo, variant):
    """Whole-prompt, chunked and paged prefill over 5 requests on 2 slots;
    a paged prefix hit; a tight pool that preempts and resumes. Dense and
    paged streams of the port agree, as JAX's
    test_int4_engine_dense_matches_paged_streams asserts for its own."""
    pair = nemo
    vocab = pair.jcfg.vocab_size
    prompts = _prompts(vocab, (5, 13, 20, 9, 17), seed=1)
    streams = {}
    for mode, kw in {"dense": {}, "chunked": {"prefill_chunk": 4},
                     "paged": {"paged": True, "block_size": 8}}.items():
        streams[mode], m = _run_same(
            pair.engines(variant, **kw),
            [(p, {"max_new_tokens": 6}) for p in prompts])
        assert m["kv_hbm_bytes_per_req"] > 0
    assert streams["paged"] == streams["dense"]

    prefix = _prompts(vocab, (16,), seed=15)[0]
    hits = [np.concatenate([prefix, own], axis=1)
            for own in _prompts(vocab, (4, 5), seed=16)]
    engines = pair.engines(variant, paged=True, block_size=8)
    for p in hits:            # one at a time: the second hits the first
        _run_same(engines, [(p, {"max_new_tokens": 3})])
    assert engines[1].metrics()["prefix_hit_tokens"] == 16

    tight = pair.engines(variant, n_slots=3, paged=True, block_size=8,
                         n_blocks=8)
    _, m = _run_same(tight, [(p, {"max_new_tokens": 6}) for p in prompts])
    assert m["preempted"] > 0 and tight[1].kv.alloc.in_use == 0


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_int4kv_session_generate_matches_jax(nemo, variant):
    jp, tp = nemo.params[variant]
    js = JSession(jp, nemo.jcfg)
    ts = InferenceSession(tp, nemo.tcfg, device="cpu")
    toks = np.random.default_rng(11).integers(0, nemo.jcfg.vocab_size,
                                              (2, 17))
    want = np.asarray(js.generate({"tokens": jnp.asarray(toks)}, 6))
    got = ts.generate({"tokens": torch.as_tensor(toks)}, 6)
    np.testing.assert_array_equal(got.numpy(), want)
