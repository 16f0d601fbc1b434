"""The port's int8 KV-cache tier against the JAX package: the quantizer bit
for bit, the three fused-dequant plain versions against the Pallas kernels
(interpret mode), the trash-block isolation of the paged plain version,
dense and paged prefill + decode on bridged weights, and greedy streams of
the session and both engines. The CUDA kernels are held against the plain
versions in test_torch_cuda.py."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_prefill import flash_qprefill_attention  # noqa: E402
from repro.kernels.paged_attn import paged_qdecode_attention  # noqa: E402
from repro.kernels.qdecode import qdecode_attention  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
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
from repro_torch.kernels import qdecode as t_qdecode  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
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
INT8KV = {"dtype": "float32", "kv_cache_int8": True}
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
# The quantizer: bit for bit
# ------------------------------------------------------------------ #
def _kv_rows(dtype):
    """[2, 3, 2, 16] K/V: rows whose absmax is 127 * 2**k (a power-of-two
    scale, so every quotient is exact and the .5 ones test the rounding),
    an all-zero row (the 1e-8 floor) and random rows."""
    rng = np.random.default_rng(4)
    t = rng.normal(size=(2, 3, 2, 16)).astype(np.float32) * 3
    halves = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                       3.5, 64.5, -64.5, 0, 1, -127, 10.5], np.float32)
    t[0, 0, 0] = halves
    t[0, 0, 1] = halves * 0.25
    t[1, 2, 0] = halves * 8
    t[1, 1, 1] = 0
    if dtype == "bfloat16":
        import ml_dtypes

        return t.astype(ml_dtypes.bfloat16)
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax_bit_for_bit(dtype):
    t = _kv_rows(dtype)
    tt = torch.from_numpy(t.astype(np.float32))
    if dtype == "bfloat16":
        tt = tt.to(torch.bfloat16)
    got_q, got_s = t_attn._quantize_kv(tt)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_q[0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126,
                                       4, 64, -64, 0, 1, -127, 10]
    assert float(got_s[1, 1, 1]) == np.float32(1e-8) / np.float32(127)
    for want_q, want_s in (j_attn._quantize_kv(jnp.asarray(t)),
                           j_ref.quantize_kv_ref(jnp.asarray(t))):
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    rq, rs = t_ref.quantize_kv_ref(tt)
    assert torch.equal(rq, got_q) and torch.equal(rs, got_s)


# ------------------------------------------------------------------ #
# Plain versions against the Pallas kernels (interpret mode)
# ------------------------------------------------------------------ #
def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _scales(rng, shape):
    # dequantized values of order 1, as quantized K/V are
    return (rng.uniform(0.5, 1.5, shape) / 127).astype(np.float32)


def _qdecode_case(seed, b, s, hkv, g, hd):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    bias = np.zeros((b, s), np.float32)
    for i in range(b):                       # a masked tail after each pos
        bias[i, rng.integers(0, s):] = NEG_INF
        bias[i, 0] = 0.0
    return (q, _codes(rng, (b, s, hkv, hd)), _scales(rng, (b, s, hkv)),
            _codes(rng, (b, s, hkv, hd)), _scales(rng, (b, s, hkv)), bias)


@pytest.mark.parametrize("s", [1, 37, 128])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
def test_qdecode_ref_matches_pallas(g, hd, s):
    case = _qdecode_case(g * hd + s, 3, s, 2, g, hd)
    want = np.asarray(qdecode_attention(*_j(*case), interpret=True))
    got = t_ref.qdecode_ref(*_t(*case))
    assert got.dtype == torch.float32 and got.shape == case[0].shape
    # f32 both sides; dequantize-then-dot against the kernel's dot-then-scale
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _paged_q_case(seed, b, hkv, g, hd, bs, m, pos, holes=()):
    """As test_torch_paged's case, over int8 pools with f32 scale pools."""
    rng = np.random.default_rng(seed)
    n = b * m + 3
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    pools = (_codes(rng, (n, bs, hkv, hd)), _scales(rng, (n, bs, hkv)),
             _codes(rng, (n, bs, hkv, hd)), _scales(rng, (n, bs, hkv)))
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
def test_paged_qdecode_ref_matches_pallas(g, hd, bs):
    pos = [0, 4 * bs - 1, 2 * bs, 3 * bs + 5]
    case = _paged_q_case(g * hd + bs, 4, 2, g, hd, bs, 5, pos,
                         holes=[(3, 1)])
    want = np.asarray(paged_qdecode_attention(*_j(*case), interpret=True))
    got = t_ref.paged_qdecode_ref(*_t(*case))
    assert got.dtype == torch.float32 and got.shape == case[0].shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,s,hq,hkv,hd,dv", [(1, 1, 4, 4, 32, 32),
                                              (2, 77, 4, 2, 32, 48),
                                              (1, 130, 8, 2, 64, 64),
                                              (1, 256, 4, 1, 16, 24)])
def test_flash_qprefill_ref_matches_pallas(b, s, hq, hkv, hd, dv):
    rng = np.random.default_rng(s + hd)
    q = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    case = (q, _codes(rng, (b, s, hkv, hd)), _scales(rng, (b, s, hkv)),
            _codes(rng, (b, s, hkv, dv)), _scales(rng, (b, s, hkv)))
    want = np.asarray(flash_qprefill_attention(*_j(*case), interpret=True))
    got = t_ref.flash_qprefill_ref(*_t(*case))
    assert got.shape == (b, s, hq, dv)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_paged_qdecode_idle_row_and_poisoned_trash_block():
    """An idle slot (table all -1, pos 0) is 0/0; the NaN scales and any
    codes it writes into the trash block never reach a live row."""
    case = list(_paged_q_case(3, 3, 2, 2, 64, 8, 4, [12, 0, 20],
                              holes=[(2, 1)]))
    case[5][1] = -1
    clean = t_ref.paged_qdecode_ref(*_t(*case)).numpy()
    assert np.isnan(clean[1]).all() and np.isfinite(clean[[0, 2]]).all()
    want = np.asarray(paged_qdecode_attention(*_j(*case), interpret=True))
    np.testing.assert_allclose(clean[[0, 2]], want[[0, 2]], atol=1e-5,
                               rtol=0)
    for pool in (1, 2, 3, 4):               # codes -128, scales NaN
        case[pool][0] = np.nan if case[pool].dtype == np.float32 else -128
    poisoned = t_ref.paged_qdecode_ref(*_t(*case)).numpy()
    np.testing.assert_array_equal(poisoned[[0, 2]], clean[[0, 2]])


def test_int8_wrappers_take_plain_versions_on_cpu_and_check_operands():
    dq = _t(*_qdecode_case(1, 2, 20, 2, 2, 32))
    pq = _t(*_paged_q_case(2, 2, 2, 2, 32, 8, 3, [5, 17]))
    rng = np.random.default_rng(3)
    fq = _t(rng.normal(size=(1, 9, 4, 32)).astype(np.float32),
            _codes(rng, (1, 9, 2, 32)), _scales(rng, (1, 9, 2)),
            _codes(rng, (1, 9, 2, 32)), _scales(rng, (1, 9, 2)))
    counters = (t_qdecode.qdecode, paged_attn.paged_qdecode,
                flash_prefill.flash_qprefill)
    before = [fn.launches for fn in counters]
    assert torch.equal(ops.qdecode(*dq), t_ref.qdecode_ref(*dq))
    assert torch.equal(ops.paged_qdecode(*pq), t_ref.paged_qdecode_ref(*pq))
    assert torch.equal(ops.flash_qprefill(*fq), t_ref.flash_qprefill_ref(*fq))
    assert [fn.launches for fn in counters] == before
    with pytest.raises(TypeError):            # fp codes
        t_qdecode.qdecode(dq[0], dq[1].float(), *dq[2:])
    with pytest.raises(ValueError):           # hd not a multiple of 16
        codes = torch.zeros(2, 20, 2, 8, dtype=torch.int8)
        t_qdecode.qdecode(torch.zeros(2, 2, 2, 8), codes, dq[2], codes,
                          dq[4], dq[5])
    with pytest.raises(ValueError):           # scale pool shape
        paged_attn.paged_qdecode(pq[0], pq[1], pq[2][:, :4], *pq[3:])
    with pytest.raises(TypeError):            # fp pools
        paged_attn.paged_qdecode(pq[0], pq[1].float(), pq[2],
                                 pq[3].float(), *pq[4:])
    with pytest.raises(ValueError):           # scales [B,S,Hkv]
        flash_prefill.flash_qprefill(*fq[:2], fq[2][:, :3], *fq[3:])


# ------------------------------------------------------------------ #
# Models on bridged weights
# ------------------------------------------------------------------ #
class _Pair:
    def __init__(self, arch):
        self.jcfg = j_configs.smoke_config(arch).with_overrides(**INT8KV)
        self.tcfg = t_configs.smoke_config(arch).with_overrides(**INT8KV)
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


def _assert_leaves_match(got, want, written):
    """Codes equal at every written slot, scales within the fp pools' K/V
    tolerance carried through the /127 (atol 1e-5 / 127; test_torch_paged
    holds fp K/V to 1e-5). K and V come out of f32 matmuls and RoPE in
    another order than JAX's, so a .5 quotient may round the other way:
    such flips are counted and must stay rare (one code step of one
    element)."""
    flips = 0
    for g, w in zip(got, want):
        g, w = g[:, written], w[:, written]
        if w.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1
            flips += int((diff > 0).sum())
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 / 127)
    assert flips <= 2, flips          # 0 seen on every case here


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_int8kv_prefill_decode_match_jax_dense_and_paged(pair, variant):
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
    for i in range(2):
        row = lambda a, i=i: a[:, i]                    # noqa: E731
        _assert_leaves_match([row(a) for a in t_back],
                             [row(a) for a in j_back], slice(0, int(pos[i])))
    tp_back = cache_to_jax(t_pools)["layers"]
    jp_back = [np.asarray(a) for a in j_pools["layers"]]
    for i in range(2):
        n = int(pos[i])
        blocks = TABLES[i, :-(-n // BS)]

        def flat(a, blocks=blocks):
            w = a[:, blocks]
            return w.reshape(w.shape[0], -1, *w.shape[3:])
        _assert_leaves_match([flat(a) for a in tp_back],
                             [flat(a) for a in jp_back], slice(0, n))


def test_int8_cache_bridge_round_trips(pair):
    toks = jnp.asarray(np.random.default_rng(2).integers(
        0, pair.jcfg.vocab_size, (2, 9)))
    jp, _ = pair.params["fp32"]
    _, jcache = j_prefill(jp, {"tokens": toks}, pair.jcfg, pad_to=16)
    jnp_cache = jax.tree.map(np.asarray, jcache)
    tcache = cache_from_jax(jnp_cache, "cpu")
    assert len(tcache["layers"]) == pair.tcfg.n_layers
    assert [t.dtype for t in tcache["layers"][0]] == [
        torch.int8, torch.float32, torch.int8, torch.float32]
    for a, b in zip(cache_to_jax(tcache)["layers"], jnp_cache["layers"]):
        np.testing.assert_array_equal(a, b)
    ref = init_cache(pair.tcfg, 2, 16, device="cpu")["layers"][0]
    assert [t.shape for t in tcache["layers"][0]] == [t.shape for t in ref]
    pools = t_kv.init_paged_pools(pair.tcfg, 5, 4, device="cpu")
    per_token = sum(t[0, 0].numel() * t.element_size()
                    for t in pools["layers"][0])
    assert per_token == t_kv.kv_bytes_per_token(pair.tcfg)


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
def test_int8kv_engine_streams_match_jax(nemo, variant):
    """Whole-prompt, chunked and paged prefill over 5 requests on 2 slots;
    a paged prefix hit; a tight pool that preempts and resumes. Dense and
    paged streams of the port agree (the same quantized values flow
    through qdecode and paged_qdecode)."""
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
def test_int8kv_session_generate_matches_jax(nemo, variant):
    jp, tp = nemo.params[variant]
    js = JSession(jp, nemo.jcfg)
    ts = InferenceSession(tp, nemo.tcfg, device="cpu")
    toks = np.random.default_rng(11).integers(0, nemo.jcfg.vocab_size,
                                              (2, 17))
    want = np.asarray(js.generate({"tokens": jnp.asarray(toks)}, 6))
    got = ts.generate({"tokens": torch.as_tensor(toks)}, 6)
    np.testing.assert_array_equal(got.numpy(), want)
