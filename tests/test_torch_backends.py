"""The port's kernel Backend registry (``repro_torch.api.backends``) against
the JAX package's (``repro.api.backends``): the registry surface and scoped
selection, every primitive of ``ref`` on numpy inputs from a seed against
JAX's ``ref``, the ``*-tp`` twins' delegation, ``cuda``'s refusal of CPU
tensors, sessions pinned per backend over one bridged dynamic-int8 artifact
against JAX's ``ref`` and ``pallas-interpret`` sessions, the routing of a
registered counting backend through an engine's shard threads, a draft and
``EngineConfig``, and the fleet pool's stats keys."""
import collections
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.api import backends as jb  # noqa: E402
from repro.fleet import simulator as j_sim  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api import backends as tb  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.fleet import simulator as t_sim  # noqa: E402
from repro_torch.kernels import dynquant, flash_prefill, paged_attn  # noqa: E402
from repro_torch.kernels import qdecode, qmatmul, quantize  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, InferenceSession)
from repro_torch.serving.spec_decode import SpecConfig  # noqa: E402

NEG_INF = -2.0e38
N_NEW = 5


# --------------------------------------------------------------------- #
# Registry surface and scoping (tests/test_api.py:192-210)
# --------------------------------------------------------------------- #
def test_registry_surface():
    assert tapi.available_backends() == ["cuda", "cuda-tp", "ref", "ref-tp"]
    for name in tapi.available_backends():
        assert tapi.get_backend(name).name == name
    assert isinstance(tapi.get_backend("ref"), tapi.RefBackend)
    assert isinstance(tapi.get_backend("cuda"), tapi.CudaBackend)
    for twin, inner in (("ref-tp", "ref"), ("cuda-tp", "cuda")):
        b = tapi.get_backend(twin)
        assert isinstance(b, tapi.TPBackend)
        assert b.inner.name == inner and b.default_tp == 2
    assert tapi.get_backend("cuda-tp").device_types == ("cuda",)
    ref = tapi.get_backend("ref")
    assert tapi.get_backend(ref) is ref and repr(ref) == "<Backend ref>"
    for mod in (tapi, jb):
        with pytest.raises(KeyError, match="registered backends"):
            mod.get_backend("cuda-imaginary")
    # no card here: the process default is the plain path
    assert tapi.default_backend().name == "ref"


def test_use_backend_scoping_and_default():
    assert tb.current_backend().name == "ref"
    with tapi.use_backend("cuda") as outer:
        assert outer.name == "cuda" and tb.current_backend() is outer
        with tapi.use_backend("ref-tp"):
            assert tb.current_backend().name == "ref-tp"
        with tapi.use_backend(None) as same:     # None keeps the scope
            assert same is outer
        assert tb.current_backend().name == "cuda"
    assert tb.current_backend().name == "ref"
    try:
        tapi.set_default_backend("ref-tp")
        assert tb.current_backend().name == "ref-tp"
        with tapi.use_backend("ref"):
            assert tb.current_backend().name == "ref"
    finally:
        tapi.set_default_backend(None)            # re-resolve
    assert tb.default_backend().name == "ref"


# --------------------------------------------------------------------- #
# ``ref`` primitive by primitive against JAX's ``ref``
# --------------------------------------------------------------------- #
def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _scales(rng, shape):
    return (rng.uniform(0.5, 1.5, shape) / 127).astype(np.float32)


def _packed(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _gscales(rng, shape):
    return (rng.uniform(0.5, 1.5, shape) / 7).astype(np.float16)


def _tables(rng, b, m, n, bs, pos):
    ids = iter(rng.permutation(np.arange(1, n)))
    tables = np.full((b, m), -1, np.int32)
    for i, p in enumerate(pos):
        for j in range(p // bs + 1):
            tables[i, j] = next(ids)
    return tables, np.asarray(pos, np.int32)


def _case(name, rng):
    """numpy inputs of one primitive at a small size."""
    b, s, hq, hkv, hd, bs, m = 2, 12, 4, 2, 32, 8, 3
    g, n = hq // hkv, b * m + 3
    if name.startswith("qmatmul") or name == "quantize_weights":
        x = rng.normal(size=(5, 40)).astype(np.float32)
        w = rng.normal(size=(40, 24)).astype(np.float32)
        if name == "quantize_weights":
            return (w,)
        codes = _codes(rng, (40, 24))
        ws = _scales(rng, (1, 24))
        if "static" in name:
            return x, codes, ws, np.float32(0.02)
        return x, codes, ws
    qd = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    qp = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    tables, pos = _tables(rng, b, m, n, bs, [5, 17])
    if name == "flash_prefill":
        kv = rng.normal(size=(2, b, s, hkv, hd)).astype(np.float32)
        return qp, kv[0], kv[1]
    if name == "flash_qprefill":
        return (qp, _codes(rng, (b, s, hkv, hd)), _scales(rng, (b, s, hkv)),
                _codes(rng, (b, s, hkv, hd)), _scales(rng, (b, s, hkv)))
    if name == "flash_q4prefill":
        return (qp, _packed(rng, (b, s, hkv, hd // 2)),
                _gscales(rng, (b, s, hkv, 1)),
                _packed(rng, (b, s, hkv, hd // 2)),
                _gscales(rng, (b, s, hkv, 1)))
    if name == "qdecode":
        bias = np.zeros((b, s), np.float32)
        bias[0, 7:] = NEG_INF
        return (qd, _codes(rng, (b, s, hkv, hd)), _scales(rng, (b, s, hkv)),
                _codes(rng, (b, s, hkv, hd)), _scales(rng, (b, s, hkv)),
                bias)
    if name == "paged_decode":
        pools = rng.normal(size=(2, n, bs, hkv, hd)).astype(np.float32)
        return qd, pools[0], pools[1], tables, pos
    if name == "paged_qdecode":
        return (qd, _codes(rng, (n, bs, hkv, hd)), _scales(rng, (n, bs, hkv)),
                _codes(rng, (n, bs, hkv, hd)), _scales(rng, (n, bs, hkv)),
                tables, pos)
    assert name == "paged_q4decode"
    return (qd, _packed(rng, (n, bs, hkv, hd // 2)),
            _gscales(rng, (n, bs, hkv, 1)),
            _packed(rng, (n, bs, hkv, hd // 2)),
            _gscales(rng, (n, bs, hkv, 1)), tables, pos)


def _t(args):
    return tuple(torch.from_numpy(np.asarray(a)) for a in args)


def _np(out):
    if isinstance(out, tuple):
        return tuple(_np(o) for o in out)
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


JAX_PRIMITIVES = ("qmatmul_static", "qmatmul_dynamic", "quantize_weights",
                  "qdecode", "paged_decode", "paged_qdecode",
                  "paged_q4decode", "flash_prefill", "flash_qprefill",
                  "flash_q4prefill")
PACKED = {"qmatmul_static_packed": "qmatmul_static",
          "qmatmul_dynamic_packed": "qmatmul_dynamic"}
PRIMITIVES = JAX_PRIMITIVES + tuple(PACKED)


def _both(name, seed=0):
    """(port inputs, JAX's output) of one primitive: the packed pair gets
    ``pack_weight`` of the codes JAX's unpacked primitive takes."""
    args = _case(PACKED.get(name, name), np.random.default_rng(seed))
    want = getattr(jb.get_backend("ref"), PACKED.get(name, name))(
        *(jnp.asarray(a) for a in args))
    targs = _t(args)
    if name in PACKED:
        targs = (targs[0], qmatmul.pack_weight(targs[1]), *targs[2:])
    return targs, _np(want)


@pytest.mark.parametrize("name", PRIMITIVES)
def test_ref_primitive_matches_jax_ref(name):
    targs, want = _both(name, seed=len(name))
    got = _np(getattr(tapi.get_backend("ref"), name)(*targs))
    if name == "quantize_weights":     # int8 codes and scales bit for bit
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        return
    assert got.shape == want.shape and got.dtype == np.float32
    if name.startswith("qmatmul"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_ref_packed_pair_equals_unpacked(out_dtype):
    ref = tapi.get_backend("ref")
    for name, plain in PACKED.items():
        (x, w_packed, *rest), _ = _both(name)
        (_, w_int8, *_), _ = _both(plain)
        got = getattr(ref, name)(x, w_packed, *rest, out_dtype=out_dtype)
        want = getattr(ref, plain)(x, w_int8, *rest, out_dtype=out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", PRIMITIVES)
def test_tp_twin_delegates_bit_for_bit(name):
    targs, _ = _both(name, seed=3)
    outs = [getattr(tapi.get_backend(b), name)(*targs)
            for b in ("ref", "ref-tp")]
    for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in outs)):
        assert torch.equal(a, b)


KERNEL_ENTRY = {"qmatmul_static": (qmatmul, "qmatmul_static"),
                "qmatmul_dynamic": (dynquant, "qmatmul_dynamic"),
                "qmatmul_static_packed": (qmatmul, "qmatmul_static_packed"),
                "qmatmul_dynamic_packed": (dynquant, "qmatmul_dynamic_packed"),
                "quantize_weights": (quantize, "quantize_weights"),
                "qdecode": (qdecode, "qdecode"),
                "paged_decode": (paged_attn, "paged_decode"),
                "paged_qdecode": (paged_attn, "paged_qdecode"),
                "paged_q4decode": (paged_attn, "paged_q4decode"),
                "flash_prefill": (flash_prefill, "flash_prefill"),
                "flash_qprefill": (flash_prefill, "flash_qprefill"),
                "flash_q4prefill": (flash_prefill, "flash_q4prefill")}


@pytest.mark.parametrize("name", PRIMITIVES)
def test_cuda_backend_refuses_cpu_tensors(name, monkeypatch):
    """``cuda`` (and its twin) raise on a CPU tensor before the kernel
    entry is reached, whose CPU branch would compute the plain version."""
    mod, attr = KERNEL_ENTRY[name]
    reached = []
    monkeypatch.setattr(mod, attr, lambda *a, **kw: reached.append(a))
    targs, _ = _both(name, seed=5)
    for backend in ("cuda", "cuda-tp"):
        with pytest.raises(ValueError, match="cpu"):
            getattr(tapi.get_backend(backend), name)(*targs)
    assert reached == []


# --------------------------------------------------------------------- #
# Sessions pinned per backend over one artifact (tests/test_api.py:212-226)
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def lm():
    """stablelm-1.6b's smoke config in f32, JAX's params and their bridge."""
    jcfg = j_configs.smoke_config("stablelm-1.6b").with_overrides(
        dtype="float32")
    tcfg = t_configs.smoke_config("stablelm-1.6b").with_overrides(
        dtype="float32")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg, "cpu")


def test_sessions_pinned_per_backend_match_jax(lm):
    jcfg, tcfg, jp, tp = lm
    jq, _ = japi.VariantSpec.dynamic_int8().build(jp, jcfg)
    art = tapi.ModelArtifact.create("m", "v1", tp, tcfg)
    tq, _ = tapi.VariantSpec.dynamic_int8().build(art.params, tcfg)
    pinned = art.with_variant("dynamic_int8", tq).session(backend="ref",
                                                          device="cpu")
    unpinned = InferenceSession(tq, tcfg, device="cpu")
    assert pinned.backend.name == "ref" and unpinned.backend is None
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 16))
    got = pinned.logits({"tokens": torch.as_tensor(toks)}).numpy()
    np.testing.assert_array_equal(
        unpinned.logits({"tokens": torch.as_tensor(toks)}).numpy(), got)
    jbatch = {"tokens": jnp.asarray(toks)}
    for name in ("ref", "pallas-interpret"):
        js = japi.InferenceSession(jq, jcfg, backend=name)
        np.testing.assert_allclose(got, np.asarray(js.logits(jbatch)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    want = japi.InferenceSession(jq, jcfg, backend="ref").generate(
        {"tokens": jnp.asarray(toks[:1, :9])}, N_NEW)
    out = pinned.generate({"tokens": torch.as_tensor(toks[:1, :9])}, N_NEW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_cuda_pin_on_the_cpu_raises_at_construction(lm):
    _, tcfg, _, tp = lm
    art = tapi.ModelArtifact.create("m", "v1", tp, tcfg)
    for name in ("cuda", "cuda-tp"):
        with pytest.raises(ValueError, match=f"backend '{name}'"):
            InferenceSession(tp, tcfg, backend=name, device="cpu")
        with pytest.raises(ValueError, match=f"backend '{name}'"):
            art.session(backend=name, device="cpu")
        with pytest.raises(ValueError, match=f"backend '{name}'"):
            ContinuousBatchingEngine(tp, tcfg, backend=name, device="cpu")
    with pytest.raises(KeyError, match="registered backends"):
        InferenceSession(tp, tcfg, backend="pallas-tpu", device="cpu")


# --------------------------------------------------------------------- #
# A registered counting backend proves the routing
# --------------------------------------------------------------------- #
class Counting(tb.RefBackend):
    """``ref`` that counts each primitive and the threads it ran on."""

    def __init__(self, name):
        self.name = name
        self.calls = collections.Counter()
        self.threads = set()
        for prim in PRIMITIVES:
            setattr(self, prim, self._counted(prim, getattr(super(), prim)))

    def _counted(self, prim, fn):
        def call(*args, **kw):
            self.calls[prim] += 1
            self.threads.add(threading.get_ident())
            return fn(*args, **kw)

        return call


@pytest.fixture
def counting():
    made = []

    def make(name):
        made.append(name)
        return tapi.register_backend(Counting(name))

    yield make
    for name in made:
        tb._BACKENDS.pop(name, None)


@pytest.fixture(scope="module")
def nemo():
    """mistral-nemo-12b's smoke config in f32 (GQA, kv heads that two
    shards divide) and its bridged params."""
    cfg = t_configs.smoke_config("mistral-nemo-12b").with_overrides(
        dtype="float32")
    jcfg = j_configs.smoke_config("mistral-nemo-12b").with_overrides(
        dtype="float32")
    jp = j_init(jax.random.PRNGKey(2), jcfg)
    return cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


PROMPTS = [(1, 9), (3, 17)]


def _streams(engine, vocab, new=6):
    reqs = [engine.submit(torch.arange(a, b)[None, :] % vocab,
                          max_new_tokens=new) for a, b in PROMPTS]
    engine.run()
    assert all(r.done for r in reqs)
    return [tuple(r.out_tokens) for r in reqs]


def test_counting_backend_sees_both_shard_threads(nemo, counting):
    """Pinned on a tp=2 engine, the backend is bound inside each shard's
    worker thread (``ShardGroup.run`` copies the caller's context)."""
    cfg, params = nemo
    counter = counting("count")
    kw = dict(n_slots=2, max_len=48, paged=True, device="cpu")
    engine = ContinuousBatchingEngine(params, cfg, backend="count", tp=2,
                                      **kw)
    assert engine.tp == 2 and engine.backend is counter
    got = _streams(engine, cfg.vocab_size)
    assert counter.calls["flash_prefill"] > 0
    assert counter.calls["paged_decode"] > 0
    assert len(counter.threads) == 2
    assert threading.get_ident() not in counter.threads
    assert got == _streams(ContinuousBatchingEngine(params, cfg, **kw),
                           cfg.vocab_size)


def test_counting_backend_as_draft_sees_only_the_draft(nemo, counting):
    """An fp32 target pinned to one counter and its dynamic-int8 draft to
    another: only the draft's counter sees int8 linears, and the streams
    are the unpinned spec engine's."""
    cfg, params = nemo
    target, draft = counting("count-target"), counting("count-draft")
    dq, _ = tapi.VariantSpec.dynamic_int8().build(params, cfg)
    kw = dict(n_slots=2, max_len=48, device="cpu")

    def run(**pins):
        spec = SpecConfig(draft=(dq, cfg), k=3,
                          draft_backend=pins.pop("draft", None))
        return _streams(ContinuousBatchingEngine(params, cfg, spec=spec,
                                                 **pins, **kw),
                        cfg.vocab_size)

    base = run()
    assert run(draft="count-draft", backend="count-target") == base
    int8 = ("qmatmul_dynamic", "qmatmul_dynamic_packed")
    assert sum(draft.calls[name] for name in int8) > 0
    assert not any(name in target.calls for name in int8)
    assert target.calls["flash_prefill"] == cfg.n_layers * len(PROMPTS)
    assert draft.calls["flash_prefill"] == cfg.n_layers * len(PROMPTS)
    # the draft session's own pin is inherited when draft_backend is None
    session = InferenceSession(dq, cfg, backend="count-draft", device="cpu")
    engine = ContinuousBatchingEngine(params, cfg, device="cpu", n_slots=2,
                                      max_len=48,
                                      spec=SpecConfig(draft=session, k=3))
    assert engine.draft_backend is draft and engine.backend is None


def test_engine_config_tp_twin_shards_at_its_default(nemo):
    """``EngineConfig(backend="ref-tp")`` opts into tp=2 with the unsharded
    engine's streams; an explicit tp=2 swaps a pinned ``ref`` for its twin
    (tests/test_sharded_serving.py:258-272)."""
    cfg, params = nemo
    kw = dict(n_slots=2, max_len=48, paged=True, device="cpu")
    one = _streams(ContinuousBatchingEngine(params, cfg, **kw),
                   cfg.vocab_size)
    twin = ContinuousBatchingEngine(params, cfg,
                                    config=EngineConfig(backend="ref-tp"),
                                    **kw)
    assert twin.tp == 2 and twin.backend.name == "ref-tp"
    assert _streams(twin, cfg.vocab_size) == one
    swapped = ContinuousBatchingEngine(params, cfg, backend="ref", tp=2, **kw)
    assert swapped.tp == 2 and swapped.backend.name == "ref-tp"
    session = InferenceSession(params, cfg, backend="ref-tp", device="cpu")
    assert ContinuousBatchingEngine(session, n_slots=2, max_len=48).tp == 2


# --------------------------------------------------------------------- #
# Fleet: agents pinned ``ref`` give JAX's pool keys
# --------------------------------------------------------------------- #
def test_engine_pool_pinned_ref_stats_keys_match_jax(lm, tmp_path):
    jcfg, tcfg, jp, tp = lm
    jreg = japi.ArtifactRegistry(str(tmp_path / "jax"))
    treg = tapi.ArtifactRegistry(str(tmp_path / "port"))
    jref = jreg.publish_variants(japi.ModelArtifact.create("m", "v1", jp,
                                                           jcfg),
                                 [japi.VariantSpec.fp32()])["fp32"].ref
    tref = treg.publish_variants(tapi.ModelArtifact.create("m", "v1", tp,
                                                           tcfg),
                                 [tapi.VariantSpec.fp32()])["fp32"].ref
    jpool, tpool = j_sim.EnginePool(jreg), t_sim.EnginePool(treg)
    profile = tapi.DeviceProfile(memory_bytes=10**10)
    jagents = [j_sim.SimAgent(f"d{i}", jreg, profile, backend="ref",
                              pool=jpool) for i in range(2)]
    tagents = [t_sim.SimAgent(f"d{i}", treg, profile, backend="ref",
                              device="cpu", pool=tpool) for i in range(2)]
    for a in jagents:
        a.activate(jref)
    for a in tagents:
        a.activate(tref)
    assert list(tpool.stats()) == list(jpool.stats()) == ["m:v1:fp32@ref"]
    assert tagents[0].session is tagents[1].session
    assert tagents[0].session.backend.name == "ref"
    # an unpinned agent on the same pool gets its own session, keyed by
    # its device as before
    other = t_sim.SimAgent("d9", treg, profile, device="cpu", pool=tpool)
    other.activate(tref)
    assert other.session is not tagents[0].session
    assert list(tpool.stats()) == ["m:v1:fp32@ref", "m:v1:fp32@cpu"]
    spec = t_sim.DeviceSpec("d3", profile, backend="ref", device="cpu")
    assert (spec.backend, spec.device) == ("ref", "cpu")
