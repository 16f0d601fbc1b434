"""Tensor-parallel engines on the CPU: the port's tp=2 greedy streams equal
its tp=1 streams and the JAX engine's tp=1 streams on bridged weights, for
GQA (dense and paged, over the fp, int8 and int4 KV tiers), MLA (dense,
paged), speculative decoding with an unsharded draft and
``EngineConfig(tp=2)``; metrics and the per-device budget as the JAX
package states them. (JAX's own TP engine holds its tp=2 to its tp=1; it
does not run under two forced host devices on this jax, ROADMAP Queue 3,
so the port is held to JAX's tp=1 streams.)"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving.scheduler import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving.spec_decode import SpecConfig as JSpecConfig  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 EngineConfig)
from repro_torch.serving.kvcache import kv_bytes_per_block  # noqa: E402
from repro_torch.serving.spec_decode import SpecConfig  # noqa: E402

PROMPT_SETS = [(1, 9), (3, 17), (5, 12)]


class _Pair:
    def __init__(self, arch, seed, **over):
        self.jcfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32", **over)
        self.tcfg = t_configs.smoke_config(arch).with_overrides(
            dtype="float32", **over)
        self.jp = j_init(jax.random.PRNGKey(seed), self.jcfg)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp),
                                  self.tcfg, "cpu")


@pytest.fixture(scope="module")
def gqa():
    return _Pair("mistral-nemo-12b", 0)


@pytest.fixture(scope="module")
def mla():
    # the MLA smoke config is MoE by default; TP shards dense stacks only
    return _Pair("deepseek-v2-236b", 1, n_experts=0)


def _streams(eng, vocab, new=8, jax_side=False):
    arr = jnp.arange if jax_side else torch.arange
    reqs = [eng.submit(arr(a, b)[None, :] % vocab, max_new_tokens=new)
            for a, b in PROMPT_SETS]
    eng.run()
    assert all(r.done for r in reqs)
    return [tuple(int(t) for t in r.out_tokens or []) for r in reqs]


def _three(pair, tier=None, **kw):
    """(JAX tp=1, port tp=1, port tp=2 engine) streams and the tp=2
    engine."""
    over = {} if tier is None else {"kv_cache_precision": tier}
    jc, tc = pair.jcfg.with_overrides(**over), pair.tcfg.with_overrides(
        **over)
    js = _streams(JEngine(pair.jp, jc, **kw), jc.vocab_size, jax_side=True)
    t1 = _streams(ContinuousBatchingEngine(pair.tp, tc, device="cpu", **kw),
                  tc.vocab_size)
    e2 = ContinuousBatchingEngine(pair.tp, tc, tp=2, device="cpu", **kw)
    return js, t1, _streams(e2, tc.vocab_size), e2


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("tier", ["fp", "int8", "int4"])
def test_tp2_gqa_streams_equal_tp1(gqa, paged, tier):
    js, t1, t2, e2 = _three(gqa, tier, n_slots=2, max_len=48, paged=paged)
    assert t2 == t1 == js
    m = e2.metrics()
    assert m["tp"] == 2
    assert m["kv_hbm_bytes_per_req_per_shard"] == \
        pytest.approx(0.5 * m["kv_hbm_bytes_per_req"])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tp2_mla_streams_equal_tp1(mla, paged):
    js, t1, t2, e2 = _three(mla, n_slots=2, max_len=48, paged=paged)
    assert t2 == t1 == js
    m = e2.metrics()
    # MLA latent caches are whole on every shard
    assert m["kv_hbm_bytes_per_req_per_shard"] == \
        pytest.approx(m["kv_hbm_bytes_per_req"])


def test_tp2_spec_decode_streams_equal_tp1(gqa):
    """The draft stays unsharded; only the target's verify and decode run
    on the shards. Committed streams equal the tp=1 spec engines'."""
    jd = gqa.jcfg.with_overrides(n_layers=1)
    td = gqa.tcfg.with_overrides(n_layers=1)
    jdp = j_init(jax.random.PRNGKey(7), jd)
    tdp = params_from_jax(jax.tree.map(np.asarray, jdp), td, "cpu")
    kw = dict(n_slots=2, max_len=48, paged=True)
    js = _streams(JEngine(gqa.jp, gqa.jcfg, spec=JSpecConfig(
        draft=(jdp, jd), k=3), **kw), gqa.jcfg.vocab_size, jax_side=True)
    spec = SpecConfig(draft=(tdp, td), k=3)
    t1 = _streams(ContinuousBatchingEngine(gqa.tp, gqa.tcfg, spec=spec,
                                           device="cpu", **kw),
                  gqa.tcfg.vocab_size)
    e2 = ContinuousBatchingEngine(gqa.tp, gqa.tcfg, spec=spec, tp=2,
                                  device="cpu", **kw)
    assert _streams(e2, gqa.tcfg.vocab_size) == t1 == js
    assert e2.metrics()["spec_events"] > 0      # verify rounds did run
    # the draft is one tree on shard 0's device, the target two
    assert isinstance(e2.draft_params, dict) and len(e2.params) == 2


@pytest.mark.parametrize("combine", ["exact", "psum"])
def test_engine_config_knob(gqa, combine):
    """EngineConfig(tp=2) turns TP on with no call-site changes; on the
    smoke model the psum combine's streams coincide with exact's too."""
    kw = dict(n_slots=2, max_len=48, paged=True, device="cpu")
    s1 = _streams(ContinuousBatchingEngine(gqa.tp, gqa.tcfg, **kw),
                  gqa.tcfg.vocab_size)
    e = ContinuousBatchingEngine(
        gqa.tp, gqa.tcfg, config=EngineConfig(tp=2, tp_combine=combine),
        **kw)
    assert e.tp == 2 and e._tp_ctx.combine == combine
    assert _streams(e, gqa.tcfg.vocab_size) == s1


def test_tp2_budget_admits_double_blocks(gqa):
    """The same per-device KV budget: a tp=2 engine's pool holds 2x the
    blocks (each shard stores half of every block). ``max_len`` is large
    enough that the doubled pool stays under the full-capacity cap."""
    budget = kv_bytes_per_block(gqa.tcfg, 16) * 6
    kw = dict(n_slots=2, max_len=256, paged=True, kv_budget_bytes=budget,
              device="cpu")
    e1 = ContinuousBatchingEngine(gqa.tp, gqa.tcfg, **kw)
    e2 = ContinuousBatchingEngine(gqa.tp, gqa.tcfg, tp=2, **kw)
    # one block is the allocator's reserved trash block
    assert e2.kv.alloc.usable_blocks + 1 == \
        2 * (e1.kv.alloc.usable_blocks + 1)
    assert e2.kv.bytes_per_block_per_shard * 2 == e1.kv.bytes_per_block


def test_shared_pool_must_match_tp(gqa):
    from repro_torch.serving import SharedKVPool

    store = SharedKVPool(gqa.tcfg, 9, 16, "cpu")
    with pytest.raises(ValueError,
                       match="shared pool built for shards=1, engine has "
                             "tp=2"):
        ContinuousBatchingEngine(gqa.tp, gqa.tcfg, n_slots=2, max_len=64,
                                 paged=True, shared_kv=store, tp=2,
                                 device="cpu")
