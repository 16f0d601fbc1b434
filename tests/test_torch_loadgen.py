"""The port's load generator: a JAX trace (its prompts and arrival ticks)
replayed on both engines gives the same streams and counting metrics; the
port's own traces are seeded; the virtual clock is the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import clock as j_clock  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving import ArrivalTrace as JTrace  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import SamplingParams as JSampling  # noqa: E402
from repro.serving import replay as j_replay  # noqa: E402
from repro_torch import clock as t_clock  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.serving import (METRIC_KEYS, ArrivalTrace,  # noqa: E402
                                 ContinuousBatchingEngine, SamplingParams,
                                 replay)

COUNTING = ("completed", "rejected", "submitted", "decode_steps",
            "generated_tokens", "prefill_tokens", "preempted",
            "prefix_hit_tokens", "prompt_tokens_computed", "kv_blocks_peak",
            "trace_requests", "offered_tokens", "clock_ticks")


@pytest.fixture(scope="module")
def setup():
    jcfg = j_configs.smoke_config("mistral-nemo-12b").with_overrides(
        dtype="float32")
    tcfg = t_configs.smoke_config("mistral-nemo-12b").with_overrides(
        dtype="float32")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("kw", [
    {"n_slots": 2, "prefill_chunk": 4},
    {"n_slots": 3, "paged": True, "block_size": 4, "n_blocks": 8},
    {"n_slots": 1, "max_queue_depth": 1},
], ids=["chunked", "paged-tight", "overload"])
def test_replay_of_jax_trace_matches_jax(setup, kw):
    jcfg, tcfg, jp, tp = setup
    jtrace = JTrace.generate(jcfg, n_requests=7, seed=5, prompt_len=(4, 14),
                             max_new=(3, 7),
                             mean_interarrival=0.0 if "max_queue_depth" in kw
                             else 1.5)
    ttrace = ArrivalTrace.from_requests(jtrace.requests, seed=jtrace.seed,
                                        mean_interarrival=1.5)
    assert [r.arrival_step for r in ttrace.requests] == \
        [r.arrival_step for r in jtrace.requests]
    je = JEngine(jp, jcfg, max_len=64, **kw)
    te = ContinuousBatchingEngine(tp, tcfg, max_len=64, device="cpu", **kw)
    jrep, trep = j_replay(je, jtrace), replay(te, ttrace)
    assert set(METRIC_KEYS) <= set(trep)
    assert {k: trep[k] for k in COUNTING} == {k: jrep[k] for k in COUNTING}
    assert [r.out_tokens for r in te.all_requests] == \
        [r.out_tokens for r in je.all_requests]
    if "n_blocks" in kw:
        assert trep["preempted"] > 0
    if "max_queue_depth" in kw:
        assert trep["rejected"] > 0
        assert trep["completed"] + trep["rejected"] == trep["submitted"] == 7


def test_generate_is_seeded_and_monotone(setup):
    _, tcfg, _, _ = setup
    a = ArrivalTrace.generate(tcfg, n_requests=8, seed=3)
    b = ArrivalTrace.generate(tcfg, n_requests=8, seed=3)
    c = ArrivalTrace.generate(tcfg, n_requests=8, seed=4)
    key = [(r.arrival_step, r.tokens.tolist(), r.max_new_tokens)
           for r in a.requests]
    assert key == [(r.arrival_step, r.tokens.tolist(), r.max_new_tokens)
                   for r in b.requests]
    assert key != [(r.arrival_step, r.tokens.tolist(), r.max_new_tokens)
                   for r in c.requests]
    steps = [r.arrival_step for r in a.requests]
    assert steps == sorted(steps)
    for r in a.requests:
        assert 4 <= r.tokens.shape[1] <= 16 and 4 <= r.max_new_tokens <= 12
        assert r.tokens.dtype == torch.int64
        assert 0 <= int(r.tokens.min()) and int(r.tokens.max()) < \
            tcfg.vocab_size
    assert a.offered_tokens == sum(r.max_new_tokens for r in a.requests)


def test_replay_reports_trace_metadata(setup):
    _, tcfg, _, tp = setup
    trace = ArrivalTrace.generate(tcfg, n_requests=4, seed=7,
                                  prompt_len=(4, 8), max_new=(3, 6),
                                  sampling=SamplingParams(temperature=0.9,
                                                          seed=2))
    engine = ContinuousBatchingEngine(tp, tcfg, n_slots=2, max_len=64,
                                      device="cpu")
    report = replay(engine, trace)
    assert report["completed"] == report["submitted"] == len(trace)
    assert report["generated_tokens"] == trace.offered_tokens
    assert report["trace_seed"] == 7 and report["clock_ticks"] > 0


def test_from_requests_carries_sampling_and_checks_order():
    reqs = [JTrace.generate(
        j_configs.smoke_config("mistral-nemo-12b"), n_requests=2, seed=1,
        sampling=JSampling(temperature=0.5, top_k=3, seed=9)).requests[i]
        for i in (0, 1)]
    trace = ArrivalTrace.from_requests(reqs)
    assert trace.requests[1].sampling == SamplingParams(0.5, 3, 9)
    with pytest.raises(ValueError):
        late = type("R", (), {"arrival_step": 10**6, "max_new_tokens": 1,
                              "tokens": np.zeros((1, 2))})()
        ArrivalTrace.from_requests([late] + reqs)


def test_virtual_clock_matches_jax():
    """The copied clock: the same ticks, event order and scoping."""
    logs = []
    for mod in (j_clock, t_clock):
        c = mod.VirtualClock()
        log = []
        c.schedule(2.0, log.append, "b")
        c.schedule(1.0, log.append, "a")
        h = c.schedule(1.0, log.append, "x")
        c.schedule(2.0, log.append, "c")
        c.cancel(h)
        c.tick(0.5)
        fired = c.run(until=5.0)
        with mod.use_clock(c):
            inside = mod.now()
        log += [fired, c.now(), c.ticks, c.pending, inside]
        logs.append(log)
    assert logs[0] == logs[1] == ["a", "b", "c", 3, 5.0, 1, 0, 5.0]
