"""The port's ContinuousBatchingEngine against the JAX engine, dense and
paged, on bridged weights: identical greedy streams and identical counting
metrics through whole-prompt and chunked prefill, prefix hits and their
demotion, preemption and resume, admission control, cancel, EOS and
streaming; plus sampling and the port's own contracts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving.scheduler import METRIC_KEYS as J_METRIC_KEYS  # noqa: E402
from repro.serving.scheduler import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.serving import (METRIC_KEYS, ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig, InferenceSession,
                                 SamplingParams, sample)
from repro_torch.serving.scheduler import _hits_eos  # noqa: E402

COUNTING = ("completed", "rejected", "cancelled", "submitted",
            "decode_steps", "generated_tokens", "prefill_tokens", "preempted",
            "prefix_hit_tokens", "prompt_tokens_computed", "kv_blocks_peak",
            "kv_hbm_bytes_per_req", "tp")


class _Pair:
    def __init__(self, arch):
        self.jcfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        jp = j_init(jax.random.PRNGKey(0), self.jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), self.tcfg, "cpu")
        self.params = {"fp32": (jp, tp)}
        jq, _ = JSpec.dynamic_int8().build(jp, self.jcfg)
        tq, _ = TSpec.dynamic_int8().build(tp, self.tcfg)
        self.params["dynamic_int8"] = (jq, tq)

    def engines(self, variant, **kw):
        jp, tp = self.params[variant]
        kw.setdefault("n_slots", 2)
        kw.setdefault("max_len", 64)
        return (JEngine(jp, self.jcfg, **kw),
                ContinuousBatchingEngine(tp, self.tcfg, device="cpu", **kw))


@pytest.fixture(scope="module")
def nemo():
    return _Pair("mistral-nemo-12b")


@pytest.fixture(scope="module")
def stablelm():
    return _Pair("stablelm-1.6b")


def _prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (1, n)) for n in lens]


def _submit(engines, prompt, **kw):
    je, te = engines
    return (je.submit(jnp.asarray(prompt), **kw),
            te.submit(torch.as_tensor(prompt), **kw))


def _assert_same(engines, pairs):
    """Streams, statuses and counting metrics equal; full metric schema."""
    je, te = engines
    for jr, tr in pairs:
        assert tr.out_tokens == jr.out_tokens, tr.rid
        assert (tr.status, tr.done, tr.prefix_hit, tr.preemptions) == \
            (jr.status, jr.done, jr.prefix_hit, jr.preemptions), tr.rid
    mj, mt = je.metrics(), te.metrics()
    assert tuple(METRIC_KEYS) == tuple(J_METRIC_KEYS)
    assert set(mt) == set(J_METRIC_KEYS)
    assert {k: mt[k] for k in COUNTING} == {k: mj[k] for k in COUNTING}
    assert mt["spec_events"] == mt["acceptance_rate"] == 0


MODES = {"dense": {}, "chunked": {"prefill_chunk": 4},
         "paged": {"paged": True, "block_size": 8}}


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
@pytest.mark.parametrize("arch", ["nemo", "stablelm"])
def test_streams_match_jax(arch, variant, request):
    """5 requests on 2 slots (mid-flight admission, slot reuse) in every
    mode; the paged prompts cross block edges and leave sub-block tails."""
    pair = request.getfixturevalue(arch)
    prompts = _prompts(pair.jcfg.vocab_size, (5, 13, 20, 9, 17))
    for mode, kw in MODES.items():
        engines = pair.engines(variant, **kw)
        pairs = [_submit(engines, p, max_new_tokens=6) for p in prompts]
        for e in engines:
            e.run()
        assert all(tr.done for _, tr in pairs), mode
        _assert_same(engines, pairs)


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_prefix_hit_and_long_partial_demotion_match_jax(nemo, variant):
    """A cold run registers its blocks; a repeat hits them; a partial hit
    with a remainder longer than 2 blocks is demoted to one cold prefill,
    which registers the longer chain so the next repeat hits fully."""
    engines = nemo.engines(variant, paged=True, block_size=8)
    rng = np.random.default_rng(15)
    prefix = rng.integers(0, nemo.jcfg.vocab_size, (1, 16))
    ext = rng.integers(0, nemo.jcfg.vocab_size, (1, 32))
    long_prompt = np.concatenate([prefix, ext], axis=1)
    pairs = []
    for prompt in (np.concatenate([prefix, ext[:, :4]], axis=1), long_prompt,
                   long_prompt, np.concatenate([prefix, ext[:, :5]], axis=1)):
        pairs.append(_submit(engines, prompt, max_new_tokens=3))
        for e in engines:
            e.run()
    _assert_same(engines, pairs)
    hits = [tr.prefix_hit for _, tr in pairs]
    assert hits == [0, 0, 40, 16]
    assert pairs[2][1].out_tokens == pairs[1][1].out_tokens
    assert engines[1].kv.alloc.in_use == 0
    # the idle slot's rows are 0/0 (as in the TPU kernel) and wrote NaN K/V
    # into the trash block from layer 1 on; no live stream read it
    k_trash = engines[1].kv.pools["layers"][1][0][0]
    assert torch.isnan(k_trash).any()


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_preemption_resume_matches_jax_and_uninterrupted(nemo, variant):
    prompts = _prompts(nemo.jcfg.vocab_size, (10, 12, 13), seed=12)
    roomy = nemo.engines(variant, n_slots=3, paged=True, block_size=8)
    tight = nemo.engines(variant, n_slots=3, paged=True, block_size=8,
                         n_blocks=8)
    ref_pairs = [_submit(roomy, p, max_new_tokens=10) for p in prompts]
    pairs = [_submit(tight, p, max_new_tokens=10) for p in prompts]
    for e in roomy + tight:
        e.run()
    _assert_same(tight, pairs)
    assert tight[1].preempted_total > 0
    assert [tr.out_tokens for _, tr in pairs] == \
        [tr.out_tokens for _, tr in ref_pairs]
    assert tight[1].kv.alloc.in_use == 0


def test_failed_admission_leaves_allocator_unchanged(nemo):
    engines = nemo.engines("fp32", paged=True, block_size=8, n_blocks=8)
    hog = _submit(engines, _prompts(nemo.jcfg.vocab_size, (30,), 21)[0],
                  max_new_tokens=16)
    for _ in range(10):
        for e in engines:
            e.step()
    waiter = _submit(engines, _prompts(nemo.jcfg.vocab_size, (28,), 22)[0],
                     max_new_tokens=4)
    alloc = engines[1].kv.alloc
    snap = (alloc.stats.peak_in_use, alloc.n_free, alloc.n_cached,
            alloc.in_use, list(alloc._ref), list(alloc._free))
    engines[1]._admit()                       # probe fails: pool exhausted
    assert waiter[1].status == "queued"
    assert (alloc.stats.peak_in_use, alloc.n_free, alloc.n_cached,
            alloc.in_use, list(alloc._ref), list(alloc._free)) == snap
    engines[0]._admit()
    for e in engines:
        e.run()
    _assert_same(engines, [hog, waiter])


def test_priority_and_chunked_interplay_match_jax(nemo):
    prompt = _prompts(nemo.jcfg.vocab_size, (14,), 14)[0]
    engines = nemo.engines("fp32", n_slots=1, paged=True, block_size=8)
    low = _submit(engines, prompt, max_new_tokens=3, priority=0)
    high = _submit(engines, prompt, max_new_tokens=3, priority=2)
    for e in engines:
        e.run()
    _assert_same(engines, [low, high])
    assert high[1].finished_at < low[1].finished_at
    chunked = nemo.engines("fp32", n_slots=1, prefill_chunk=4)
    r = _submit(chunked, prompt, max_new_tokens=3)
    for e in chunked:
        e.run()
    _assert_same(chunked, [r])
    assert r[1].out_tokens == low[1].out_tokens
    assert chunked[1].prefill_tokens == 4


@pytest.mark.parametrize("paged", [False, True])
def test_admission_control_cancel_eos_streaming_match_jax(nemo, paged):
    kw = {"paged": True, "block_size": 8} if paged else {}
    prompts = _prompts(nemo.jcfg.vocab_size, (6, 11, 9, 7, 60), seed=3)
    probe = nemo.engines("fp32", n_slots=1, **kw)
    full = _submit(probe, prompts[0], max_new_tokens=5)
    for e in probe:
        e.run()
    toks = full[1].out_tokens
    stop = next(i for i in range(1, 5) if toks[i] not in toks[:i])
    eos = toks[stop]
    engines = nemo.engines("fp32", n_slots=1, max_queue_depth=3, **kw)
    streamed = []
    pairs = [
        _submit(engines, prompts[0], max_new_tokens=5, eos_id=eos),
        _submit(engines, prompts[1], max_new_tokens=4,
                on_token=lambda req, tok: streamed.append((req, tok))),
        _submit(engines, prompts[2], max_new_tokens=4),
        _submit(engines, prompts[3], max_new_tokens=4)]    # queue full
    if paged:       # 60 + 8 > max_len 64: could never fit, rejected now
        pairs.append(_submit(engines, prompts[4], max_new_tokens=8))
    for e in engines:
        e.step()
    assert [e.cancel(r) for e, r in zip(engines, pairs[2])] == [True, True]
    for e in engines:
        e.run()
    _assert_same(engines, pairs)
    t = [tr for _, tr in pairs]
    assert t[0].out_tokens == toks[:stop + 1] and t[0].done
    for jr, tr in (pairs[1],):      # each engine streams its own request
        assert [tok for r, tok in streamed if r is tr] == tr.out_tokens
        assert [tok for r, tok in streamed if r is jr] == jr.out_tokens
    assert len(streamed) == 2 * len(t[1].out_tokens)
    assert t[2].status == "cancelled" and t[3].rejected
    assert engines[1].metrics()["rejected"] == (2 if paged else 1)


# ------------------------------------------------------------------ #
# Sampling
# ------------------------------------------------------------------ #
def test_sampled_streams_independent_of_slot_layout(nemo):
    """A sampled request's stream depends on (seed, token index) only: the
    same on one slot alone as on three slots beside other requests."""
    _, tp = nemo.params["fp32"]
    prompt = torch.as_tensor(_prompts(nemo.jcfg.vocab_size, (8,), 4)[0])
    sp = SamplingParams(temperature=0.8, top_k=20, seed=11)
    alone = ContinuousBatchingEngine(tp, nemo.tcfg, n_slots=1, max_len=64,
                                     device="cpu")
    a = alone.submit(prompt, max_new_tokens=8, sampling=sp)
    alone.run()
    busy = ContinuousBatchingEngine(tp, nemo.tcfg, n_slots=3, max_len=64,
                                    device="cpu")
    others = [busy.submit(p, max_new_tokens=5, sampling=SamplingParams(
        temperature=1.0, seed=i)) for i, p in enumerate(_prompts(
            nemo.jcfg.vocab_size, (5, 9), 6))]
    b = busy.submit(prompt, max_new_tokens=8, sampling=sp)
    busy.run()
    assert a.done and b.done and all(r.done for r in others)
    assert a.out_tokens == b.out_tokens
    greedy = alone.submit(prompt, max_new_tokens=8)
    alone.run()
    assert greedy.out_tokens != a.out_tokens


def test_sample_distribution_chi_square():
    """Seeded draws follow the softmax of the scaled logits: a chi-square
    fit over 4000 draws (one per token index) stays below the 99.9%
    quantile for 7 degrees of freedom (~24.3)."""
    logits = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0])
    params = SamplingParams(temperature=1.3, seed=5)
    probs = torch.softmax(logits / params.temperature, -1).numpy()
    counts = np.zeros(8)
    for i in range(4000):
        counts[int(sample(logits, params, i))] += 1
    expected = probs * 4000
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.3, (chi2, counts.tolist())


def test_sample_top_k_and_greedy_rules():
    g = torch.Generator().manual_seed(0)
    for i in range(16):
        logits = torch.randn(16, generator=g)
        k1 = SamplingParams(temperature=0.7, top_k=1, seed=9)
        assert int(sample(logits, k1, i)) == int(torch.argmax(logits))
        draws = {int(sample(logits, SamplingParams(0.9, k, 4), i))
                 for k in (0, 16, 21)}
        assert len(draws) == 1                 # top_k >= V: no restriction
    tied = torch.tensor([3.0, 2.0, 2.0, 2.0, 1.0, 0.0])
    seen = {int(sample(tied, SamplingParams(1.0, 2, 7), i))
            for i in range(300)}
    assert seen == {0, 1, 2, 3}                # ties at the k-th stay in
    # first-maximum tie rule, as jnp.argmax
    flat = np.array([1.0, 5.0, 5.0, 2.0], np.float32)
    assert int(sample(torch.from_numpy(flat), SamplingParams(), 0)) == \
        int(jnp.argmax(jnp.asarray(flat))) == 1


# ------------------------------------------------------------------ #
# The port's own contracts
# ------------------------------------------------------------------ #
def test_metrics_schema_and_warmup_reset(nemo):
    _, tp = nemo.params["fp32"]
    for kw in ({}, {"paged": True, "block_size": 8}):
        engine = ContinuousBatchingEngine(tp, nemo.tcfg, n_slots=2,
                                          max_len=64, device="cpu", **kw)
        m = engine.metrics()
        assert set(m) == set(J_METRIC_KEYS) and m["tp"] == 1
        assert all(v == 0 for k, v in m.items() if k != "tp")
        engine.warmup()
        assert all(v == 0 for k, v in engine.metrics().items() if k != "tp")
        if kw:
            assert engine.kv.alloc.n_cached == 0
        r = engine.submit(torch.zeros((1, 4), dtype=torch.int64),
                          max_new_tokens=3)
        engine.run()
        m = engine.metrics()
        assert m["completed"] == 1 and m["kv_hbm_bytes_per_req"] > 0
        assert m["throughput_tok_s"] > 0 and r.first_token_at > 0


def test_engine_from_session_and_no_device(nemo):
    _, tp = nemo.params["fp32"]
    session = InferenceSession(tp, nemo.tcfg, device="cpu")
    engine = ContinuousBatchingEngine(session, n_slots=2, max_len=64)
    assert engine.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(tp, nemo.tcfg, n_slots=2, max_len=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(tp, nemo.tcfg, paged=True)


def test_unported_options_name_the_roadmap(nemo):
    _, tp = nemo.params["fp32"]
    cfg = nemo.tcfg
    # item 10's serving half is served: tp through the argument or the
    # config; a width tp does not divide is refused with JAX's reason
    for kw in ({"tp": 2}, {"config": EngineConfig(tp=2)}):
        assert ContinuousBatchingEngine(tp, cfg, device="cpu", **kw).tp == 2
    with pytest.raises(ValueError, match="n_heads=4 not divisible by tp=3"):
        ContinuousBatchingEngine(tp, cfg, device="cpu", tp=3)
    # item 11 is served: prefill / decode workers on a paged engine's store
    with pytest.raises(ValueError, match="shared_kv requires paged"):
        ContinuousBatchingEngine(tp, cfg, device="cpu",
                                 shared_kv=object())
    engine = ContinuousBatchingEngine(tp, cfg, n_slots=1, max_len=32,
                                      paged=True, block_size=8, device="cpu")
    req = engine.submit_prefill(torch.zeros((1, 4)))
    engine.run()
    assert req.done and req.kv_handoff.block_ids
    # the backend registry: a pinned "*-tp" twin shards at its default
    # width, and a CUDA pin on the CPU is refused at construction
    for name, want in (("ref", 1), ("ref-tp", 2)):
        engine = ContinuousBatchingEngine(tp, cfg, device="cpu",
                                          config=EngineConfig(backend=name))
        assert (engine.tp, engine.backend.name) == (want, name)
    for name in ("cuda", "cuda-tp"):
        with pytest.raises(ValueError, match="backend"):
            ContinuousBatchingEngine(tp, cfg, device="cpu",
                                     config=EngineConfig(backend=name))


def test_hits_eos_rules():
    assert not _hits_eos(5, -1)
    assert _hits_eos(5, 5) and not _hits_eos(4, 5)
    assert _hits_eos([5, 1], 5) and _hits_eos([5, 1], (5, 1))
    assert not _hits_eos([5, 2], (5, 1)) and not _hits_eos([5], (5, 1))
