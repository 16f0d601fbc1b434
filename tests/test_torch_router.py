"""Disaggregated serving in the port against the JAX package, on bridged
weights: the KV handoff between a prefill and a decode worker on one
``SharedKVPool`` (GQA, MLA, and the int8 and int4 KV tiers) replays the
single engine's streams bit for bit with no prompt recompute; the pool's
signature check; cancel releasing a queued handoff's blocks; refcount
conservation under random interleavings; and the ``ServingRouter`` on the
virtual clock, whose every ``route_trace`` / ``single_engine_trace``
metric equals the JAX router's on the same trace. The twin of
``tests/test_router.py``."""
import json
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving import ArrivalTrace as JTrace  # noqa: E402
from repro.serving import RouterConfig as JRouterConfig  # noqa: E402
from repro.serving import ServingRouter as JRouter  # noqa: E402
from repro.serving import SharedKVPool as JPool  # noqa: E402
from repro.serving import route_trace as j_route_trace  # noqa: E402
from repro.serving import single_engine_trace as j_single  # noqa: E402
from repro.serving.scheduler import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.serving import (INTERACTIVE, ArrivalTrace,  # noqa: E402
                                 ContinuousBatchingEngine, KVHandoff,
                                 RouterConfig, ServingRouter, SharedKVPool,
                                 kv_pool_signature, route_trace,
                                 single_engine_trace)


class _Pair:
    def __init__(self, arch):
        self.jcfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.jp = j_init(jax.random.PRNGKey(0), self.jcfg)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp),
                                  self.tcfg, "cpu")

    def tiered(self, kv):
        return (self.jcfg.with_overrides(kv_cache_precision=kv),
                self.tcfg.with_overrides(kv_cache_precision=kv))


@pytest.fixture(scope="module")
def nemo():
    return _Pair("mistral-nemo-12b")


def _prompts(cfg, n=3, seed=1, lo=5, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (1, int(rng.integers(lo, hi))))
            for _ in range(n)]


def _audit(alloc):
    """The free / cached / in-use partition is exact and refcounts agree."""
    free = set(alloc._free)
    cached = set(alloc._cached.values())
    assert len(free) == alloc.n_free, "duplicate ids on the free list"
    assert not (free & cached), "block both free and cached"
    assert alloc.n_free + alloc.n_cached + alloc.in_use == \
        alloc.usable_blocks
    for bid in free | cached:
        assert alloc.refcount(bid) == 0, f"nonzero refcount on idle {bid}"


def _engine(params, cfg, **kw):
    return ContinuousBatchingEngine(params, cfg, device="cpu", **kw)


def _disagg_serve(params, cfg, prompts, max_new, n_blocks=40,
                  block_size=8):
    """prompts -> prefill worker -> KVHandoff -> decode worker."""
    store = SharedKVPool(cfg, n_blocks, block_size, "cpu")
    pre = _engine(params, cfg, n_slots=2, max_len=64, paged=True,
                  shared_kv=store)
    dec = _engine(params, cfg, n_slots=2, max_len=64, paged=True,
                  shared_kv=store)
    assert pre.kv.pools is dec.kv.pools is store.pools
    streams = []
    for p in prompts:
        preq = pre.submit_prefill(p)
        pre.run()
        assert preq.done and isinstance(preq.kv_handoff, KVHandoff)
        assert preq.kv_handoff.cache_pos == p.shape[1]
        dreq = dec.submit_handoff(preq.kv_handoff, max_new_tokens=max_new)
        assert not dreq.rejected
        dec.run()
        assert dreq.done and dreq.prefix_hit == p.shape[1]
        streams.append(dreq.out_tokens)
    return streams, dec, store


def _single_streams(pair, cfgs, prompts, max_new, n_blocks=40,
                    block_size=8):
    """The port's and the JAX package's single paged engine."""
    jcfg, tcfg = cfgs
    kw = dict(n_slots=2, max_len=64, paged=True, block_size=block_size,
              n_blocks=n_blocks)
    jeng = JEngine(pair.jp, jcfg, **kw)
    teng = _engine(pair.tp, tcfg, **kw)
    jreqs = [jeng.submit(jnp.asarray(p), max_new_tokens=max_new)
             for p in prompts]
    treqs = [teng.submit(p, max_new_tokens=max_new) for p in prompts]
    jeng.run()
    teng.run()
    assert all(r.done for r in treqs)
    return ([r.out_tokens for r in jreqs], [r.out_tokens for r in treqs])


# --------------------------------------------------------------------- #
# Handoff bit-parity
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kv", ["fp", "int8", "int4"])
def test_handoff_decode_bit_identical_gqa(nemo, kv):
    """Decode after a handoff replays the single engine's stream: the
    decode worker attaches the prefill worker's blocks (the same pool
    tensors, quantized payloads and scales as they are) and recomputes
    ZERO prompt tokens."""
    cfgs = nemo.tiered(kv)
    prompts = _prompts(nemo.jcfg, n=3, seed=3)
    want_j, want_t = _single_streams(nemo, cfgs, prompts, max_new=6)
    streams, dec, store = _disagg_serve(nemo.tp, cfgs[1], prompts, 6)
    assert streams == want_t == want_j
    assert dec.prompt_tokens_computed == 0, "handoff decode recomputed KV"
    assert store.alloc.in_use == 0
    _audit(store.alloc)


def test_handoff_decode_bit_identical_mla():
    """The same contract under MLA paging (deepseek-v2: latent and rope
    pools): the handoff carries pool indices, not a layout."""
    pair = _Pair("deepseek-v2-236b")
    prompts = _prompts(pair.jcfg, n=2)
    want_j, want_t = _single_streams(pair, (pair.jcfg, pair.tcfg), prompts,
                                     max_new=5)
    streams, dec, _ = _disagg_serve(pair.tp, pair.tcfg, prompts, 5)
    assert streams == want_t == want_j
    assert dec.prompt_tokens_computed == 0


def test_shared_pool_signature_mismatch_rejected(nemo):
    """An engine may not attach to a pool built for another geometry or
    precision: block payloads would be read as the wrong layout."""
    store = SharedKVPool(nemo.tcfg, 20, 8, "cpu")
    j_store = JPool(nemo.jcfg, 20, 8)
    assert store.signature[:-3] == tuple(
        v for v in j_store.signature[:-3])
    assert store.signature == kv_pool_signature(nemo.tcfg, 20, 8)
    for bad in (nemo.tcfg.with_overrides(kv_cache_precision="int8"),
                nemo.tcfg.with_overrides(n_layers=3)):
        with pytest.raises(ValueError, match="incompatible"):
            _engine(nemo.tp, bad, n_slots=2, max_len=64, paged=True,
                    shared_kv=store)
    with pytest.raises(ValueError, match="paged=True"):
        _engine(nemo.tp, nemo.tcfg, n_slots=2, max_len=64, shared_kv=store)
    # the store's geometry wins over the engine's arguments
    eng = _engine(nemo.tp, nemo.tcfg, n_slots=2, max_len=64, paged=True,
                  block_size=16, n_blocks=99, shared_kv=store)
    assert eng.kv.block_size == 8 and eng.kv.alloc is store.alloc


# --------------------------------------------------------------------- #
# Refcount conservation
# --------------------------------------------------------------------- #
def test_cancel_releases_handoff_blocks(nemo):
    """Cancelling a queued handoff request releases the handoff's
    retained blocks; a second cancel is a no-op."""
    cfg = nemo.tcfg
    store = SharedKVPool(cfg, 40, 8, "cpu")
    pre = _engine(nemo.tp, cfg, n_slots=2, max_len=64, paged=True,
                  shared_kv=store)
    dec = _engine(nemo.tp, cfg, n_slots=1, max_len=64, paged=True,
                  shared_kv=store)
    handoffs = []
    for p in _prompts(cfg, n=3, seed=5):
        r = pre.submit_prefill(p)
        pre.run()
        handoffs.append(r.kv_handoff)
    reqs = [dec.submit_handoff(h, max_new_tokens=8) for h in handoffs]
    dec.step()
    queued = [r for r in reqs if not r.done and r.status != "decode"]
    assert queued, "expected queued handoff requests behind the busy slot"
    before = store.alloc.in_use
    for r in queued:
        assert dec.cancel(r)
        assert not dec.cancel(r), "double cancel must be a no-op"
    assert store.alloc.in_use < before
    dec.run()
    assert store.alloc.in_use == 0
    _audit(store.alloc)
    assert dec.metrics()["cancelled"] == len(queued)


def _interleave(make_engine, submit_tokens, cfg, seed):
    """Random submit / prefill capture / handoff / step / cancel on a pool
    small enough to preempt and reject; returns (streams, statuses, store
    allocator) after draining and releasing unconsumed handoffs."""
    rng = random.Random(seed)
    eng, alloc = make_engine()
    live, handoffs, seen = [], [], set()
    for i in range(40):
        op = rng.random()
        if op < 0.35:
            p = _prompts(cfg, n=1, seed=100 + i, lo=4, hi=14)[0]
            live.append(eng.submit(submit_tokens(p),
                                   max_new_tokens=rng.randint(1, 6)))
        elif op < 0.5:
            p = _prompts(cfg, n=1, seed=200 + i, lo=4, hi=14)[0]
            live.append(eng.submit_prefill(submit_tokens(p)))
        elif op < 0.6 and handoffs:
            h = handoffs.pop(rng.randrange(len(handoffs)))
            r = eng.submit_handoff(h, max_new_tokens=rng.randint(1, 5))
            if r.rejected:
                handoffs.append(h)   # a rejection leaves ownership with us
            else:
                live.append(r)
        elif op < 0.75 and live:
            eng.cancel(rng.choice(live))
        else:
            eng.step()
        for r in live:
            h = r.kv_handoff
            if r.done and h is not None and not h.consumed \
                    and id(h) not in seen:
                seen.add(id(h))
                handoffs.append(h)
        _audit(alloc)
    eng.run()
    for r in live:
        h = r.kv_handoff
        if r.done and h is not None and not h.consumed \
                and not any(x is h for x in handoffs):
            handoffs.append(h)
    for h in handoffs:
        h.release(alloc)
    return ([r.out_tokens for r in live], [r.status for r in live], alloc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refcount_conservation_property(nemo, seed):
    """Whatever the path (preemption, memory rejection, cancel, handoff
    re-submission), once the engine drains and unconsumed handoffs are
    released every refcount is zero and the partition is exact; the
    streams and statuses equal the JAX engine's under the same
    interleaving."""
    def port():
        store = SharedKVPool(nemo.tcfg, 12, 8, "cpu")
        return (_engine(nemo.tp, nemo.tcfg, n_slots=2, max_len=64,
                        paged=True, shared_kv=store, max_queue_depth=6),
                store.alloc)

    def ref():
        store = JPool(nemo.jcfg, 12, 8)
        return (JEngine(nemo.jp, nemo.jcfg, n_slots=2, max_len=64,
                        paged=True, shared_kv=store, max_queue_depth=6),
                store.alloc)

    t_streams, t_status, alloc = _interleave(port, lambda p: p, nemo.tcfg,
                                             seed)
    assert alloc.in_use == 0, "leaked block refcounts"
    _audit(alloc)
    for bid in range(1, alloc.n_blocks):
        assert alloc.refcount(bid) == 0
    j_streams, j_status, _ = _interleave(ref, jnp.asarray, nemo.jcfg, seed)
    assert t_streams == j_streams and t_status == j_status


# --------------------------------------------------------------------- #
# Router end to end
# --------------------------------------------------------------------- #
def _router(pair, n_blocks=40, port=True, **cfg_kw):
    if port:
        store = SharedKVPool(pair.tcfg, n_blocks, 8, "cpu")
        make = lambda **kw: _engine(pair.tp, pair.tcfg,  # noqa: E731
                                    shared_kv=store, **kw)
        router_cls, config = ServingRouter, RouterConfig(**cfg_kw)
    else:
        store = JPool(pair.jcfg, n_blocks, 8)
        make = lambda **kw: JEngine(pair.jp, pair.jcfg,  # noqa: E731
                                    shared_kv=store, **kw)
        router_cls, config = JRouter, JRouterConfig(**cfg_kw)
    pre = [make(n_slots=2, max_len=64, paged=True, prefill_chunk=6)]
    dec = [make(n_slots=2, max_len=64, paged=True, max_queue_depth=4)
           for _ in range(2)]
    return router_cls(pre, dec, config=config)


def _traces(cfg, **kw):
    jt = JTrace.generate(cfg, **kw)
    return jt, ArrivalTrace.from_requests(
        jt.requests, seed=jt.seed, mean_interarrival=jt.mean_interarrival)


def test_router_trace_replay_matches_jax(nemo):
    """The 12-request trace of the JAX router test: every metric
    ``route_trace`` returns (virtual seconds) equals the JAX router's, the
    streams equal the JAX router's and one engine's, and the decode
    workers recompute no prompt token."""
    jt, tt = _traces(nemo.jcfg, n_requests=12, seed=9, mean_interarrival=2.0,
                     prompt_len=(4, 14), max_new=(3, 8))
    single = _engine(nemo.tp, nemo.tcfg, n_slots=4, max_len=64, paged=True,
                     block_size=8, n_blocks=40)
    sreqs = [single.submit(t.tokens, t.max_new_tokens, sampling=t.sampling)
             for t in tt.requests]
    single.run()
    router = _router(nemo)
    m = route_trace(router, tt, max_ticks=2000)
    jrouter = _router(nemo, port=False)
    jm = j_route_trace(jrouter, jt, max_ticks=2000)
    assert m == jm
    assert m["router_completed"] == len(tt.requests)
    assert m["decode_prompt_tokens_recomputed"] == 0
    for sr, rr, jr in zip(sreqs, router.requests, jrouter.requests):
        assert rr.out_tokens == sr.out_tokens == jr.out_tokens, rr.rid
        assert (rr.state, rr.ttft_s, rr.redispatches) == \
            (jr.state, jr.ttft_s, jr.redispatches)
    assert router.store.alloc.in_use == 0
    json.dumps(m, allow_nan=False)


def test_single_engine_arm_matches_jax(nemo):
    jt, tt = _traces(nemo.jcfg, n_requests=10, seed=4, mean_interarrival=1.5,
                     prompt_len=(4, 14), max_new=(3, 8))
    kw = dict(n_slots=4, max_len=64, paged=True, block_size=8, n_blocks=40,
              prefill_chunk=6)
    m = single_engine_trace(_engine(nemo.tp, nemo.tcfg, **kw), tt)
    jm = j_single(JEngine(nemo.jp, nemo.jcfg, **kw), jt)
    assert m == jm and m["single_completed"] == 10


def test_router_rejection_storm_partition(nemo):
    """A pool too small for the offered load drives worker-side
    rejections and re-dispatch. The partition survives, nothing leaks,
    every admitted request finishes, and the metrics equal JAX's."""
    prompts = _prompts(nemo.jcfg, n=20, seed=17, lo=4, hi=12)
    router = _router(nemo, n_blocks=14, max_queue_depth=6)
    rrs = [router.submit(torch.as_tensor(p), max_new_tokens=5)
           for p in prompts]
    router.run(max_ticks=3000)
    admitted = [rr for rr in rrs if rr.state != "rejected"]
    rejected = [rr for rr in rrs if rr.state == "rejected"]
    assert rejected, "the storm should trip front-door backpressure"
    assert admitted and all(rr.state == "done" for rr in admitted)
    assert router.store.alloc.in_use == 0
    _audit(router.store.alloc)
    m = router.metrics()
    assert m["router_rejected"] == len(rejected)
    assert m["router_completed"] == len(admitted)
    jrouter = _router(nemo, n_blocks=14, port=False, max_queue_depth=6)
    for p in prompts:
        jrouter.submit(jnp.asarray(p), max_new_tokens=5)
    jrouter.run(max_ticks=3000)
    assert m == jrouter.metrics()
    assert [rr.out_tokens for rr in rrs] == \
        [rr.out_tokens for rr in jrouter.requests]


def test_router_slo_classes_and_aging(nemo):
    """Interactive requests dispatch ahead of batch; a waiting ready
    handoff gains effective priority with age."""
    router = _router(nemo, age_boost_ticks=2)
    p = [torch.as_tensor(x)
         for x in _prompts(nemo.jcfg, n=6, seed=23, lo=4, hi=10)]
    batch = [router.submit(x, max_new_tokens=6) for x in p[:3]]
    inter = [router.submit(x, max_new_tokens=6, slo=INTERACTIVE)
             for x in p[3:]]
    router.run(max_ticks=1000)
    assert all(rr.state == "done" for rr in batch + inter)
    mean = lambda xs: sum(xs) / len(xs)   # noqa: E731
    assert mean([rr.ttft_s for rr in inter]) <= \
        mean([rr.ttft_s for rr in batch])
    rr = inter[0]
    assert router._effective_priority(rr) >= rr.slo.priority


def test_router_validates_shared_store(nemo):
    a = SharedKVPool(nemo.tcfg, 20, 8, "cpu")
    b = SharedKVPool(nemo.tcfg, 20, 8, "cpu")
    ea = _engine(nemo.tp, nemo.tcfg, n_slots=1, max_len=64, paged=True,
                 shared_kv=a)
    eb = _engine(nemo.tp, nemo.tcfg, n_slots=1, max_len=64, paged=True,
                 shared_kv=b)
    with pytest.raises(ValueError, match="one SharedKVPool"):
        ServingRouter([ea], [eb])
    with pytest.raises(ValueError):
        ServingRouter([], [ea])


def test_worker_entry_points_check_their_engine(nemo):
    dense = _engine(nemo.tp, nemo.tcfg, n_slots=1, max_len=64)
    prompt = _prompts(nemo.tcfg, n=1)[0]
    with pytest.raises(ValueError, match="paged"):
        dense.submit_prefill(prompt)
    store = SharedKVPool(nemo.tcfg, 40, 8, "cpu")
    pre = _engine(nemo.tp, nemo.tcfg, n_slots=1, max_len=64, paged=True,
                  shared_kv=store)
    dec = _engine(nemo.tp, nemo.tcfg, n_slots=1, max_len=64, paged=True,
                  shared_kv=store)
    with pytest.raises(ValueError, match="paged"):
        dense.submit_handoff(None)
    r = pre.submit_prefill(prompt)
    pre.run()
    dreq = dec.submit_handoff(r.kv_handoff, max_new_tokens=3)
    dec.run()
    assert dreq.done and len(dreq.out_tokens) == 3
    with pytest.raises(ValueError, match="consumed"):
        dec.submit_handoff(r.kv_handoff, max_new_tokens=3)
    # a one-token budget completes at submit and releases the handoff
    r = pre.submit_prefill(prompt)
    pre.run()
    done = dec.submit_handoff(r.kv_handoff, max_new_tokens=1)
    assert done.done and r.kv_handoff.consumed
    # the prompt's full blocks stay behind as prefix cache
    assert store.alloc.in_use == 0
    assert store.alloc.n_cached == prompt.shape[1] // 8


def test_metrics_empty_and_single_windows(nemo):
    """Zero completed requests give zeros, not NaN; one completion gives
    degenerate but finite percentiles."""
    eng = _engine(nemo.tp, nemo.tcfg, n_slots=1, max_len=64, paged=True,
                  block_size=8)
    m = eng.metrics()
    assert m["completed"] == 0
    for k in ("p50_ttft_s", "p90_ttft_s", "p99_ttft_s", "mean_ttft_s"):
        assert m[k] == 0.0
    json.dumps(m, allow_nan=False)
    r = eng.submit(_prompts(nemo.tcfg, n=1)[0], max_new_tokens=2)
    eng.run()
    m = eng.metrics([r])
    assert m["completed"] == 1
    assert m["p50_ttft_s"] == m["p99_ttft_s"] == m["mean_ttft_s"]
    router = _router(nemo)
    rm = router.metrics()
    assert rm["router_completed"] == 0 and rm["router_p99_ttft_s"] == 0.0
    json.dumps(rm, allow_nan=False)
