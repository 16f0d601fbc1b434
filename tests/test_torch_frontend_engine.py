"""Frontend requests in the port's continuous-batching engine against the
JAX package, on bridged weights: phi-3-vision (576 patch rows at full
size, 8 in the smoke config) through the dense and the paged engine, and
musicgen (conditioning frames and 2 codebooks) through the dense engine.

The embeds ride the first prefill chunk, cache positions count the
frontend rows, a frontend model hashes no prompt block (so a repeated
prompt never hits the prefix cache), and an over-long request is rejected
at submit. The JAX paged engine refuses a vlm (its ``paged_supported``
gives the recurrent stacks' reason, though a vlm caches attention K/V
only), so the port's paged streams are held to the JAX dense engine's and
to the JAX paged engine run on the same weights with ``arch_type="dense"``
(which turns on no other branch: bucketed prefill pads with inert tokens)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving.kvcache import paged_supported as j_paged  # noqa: E402
from repro.serving.scheduler import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving.spec_decode import spec_supported as j_spec  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 InferenceSession, paged_supported,
                                 spec_supported)

COUNTING = ("completed", "rejected", "submitted", "decode_steps",
            "generated_tokens", "prefill_tokens", "preempted",
            "prefix_hit_tokens", "prompt_tokens_computed", "kv_blocks_peak")


class _Arch:
    def __init__(self, arch, lens, seed):
        self.jcfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.jp = j_init(jax.random.PRNGKey(0), self.jcfg)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp),
                                  self.tcfg, "cpu")
        rng = np.random.default_rng(seed)
        cfg = self.jcfg
        tshape = (lambda n: (1, n, cfg.n_codebooks)
                  if cfg.n_codebooks > 1 else (1, n))
        self.requests = [
            (rng.integers(0, cfg.vocab_size, tshape(n)),
             rng.standard_normal((1, cfg.n_frontend_tokens,
                                  cfg.frontend_dim)).astype(np.float32))
            for n in lens]
        # the first prompt again, with other patches: no prefix hit
        self.requests.append((self.requests[0][0], self.requests[1][1]))


@pytest.fixture(scope="module")
def vlm():
    return _Arch("phi-3-vision-4.2b", (3, 21, 9, 30, 17, 12), seed=1)


@pytest.fixture(scope="module")
def music():
    return _Arch("musicgen-large", (4, 11, 7), seed=2)


def _serve(engine, requests, n_new, jax_side, embeds=None):
    conv = jnp.asarray if jax_side else (lambda a: a)
    reqs = []
    for i, (t, f) in enumerate(requests):
        with_fe = embeds is None or embeds[i]
        reqs.append(engine.submit(conv(t), n_new,
                                  frontend_embeds=conv(f) if with_fe
                                  else None))
    engine.run()
    return reqs


def _assert_same(jreqs, treqs, jeng, teng, keys=COUNTING):
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    jm, tm = jeng.metrics(), teng.metrics()
    for key in keys:
        assert tm[key] == jm[key], key


# --------------------------------------------------------------------- #
# Dense engine
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("chunk", [0, 8])
def test_vlm_dense_engine_matches_jax_and_generate(vlm, chunk):
    kw = dict(n_slots=2, max_len=64, prefill_chunk=chunk)
    jeng = JEngine(vlm.jp, vlm.jcfg, **kw)
    teng = ContinuousBatchingEngine(vlm.tp, vlm.tcfg, device="cpu", **kw)
    jreqs = _serve(jeng, vlm.requests, 5, True)
    treqs = _serve(teng, vlm.requests, 5, False)
    _assert_same(jreqs, treqs, jeng, teng)
    assert teng.metrics()["prefix_hit_tokens"] == 0
    sess = InferenceSession(vlm.tp, vlm.tcfg, device="cpu")
    for (t, f), r in zip(vlm.requests, treqs):
        got = sess.generate({"tokens": torch.as_tensor(t),
                             "frontend_embeds": torch.as_tensor(f)}, 5)
        assert got[0].tolist() == r.out_tokens


def test_vlm_request_without_embeds_matches_jax(vlm):
    """A frontend model's request without embeds keeps the JAX engine's
    positions: the cache still counts the frontend rows."""
    embeds = [i % 2 == 0 for i in range(len(vlm.requests))]
    jeng = JEngine(vlm.jp, vlm.jcfg, n_slots=2, max_len=64)
    teng = ContinuousBatchingEngine(vlm.tp, vlm.tcfg, n_slots=2, max_len=64,
                                    device="cpu")
    _assert_same(_serve(jeng, vlm.requests, 4, True, embeds),
                 _serve(teng, vlm.requests, 4, False, embeds), jeng, teng)


@pytest.mark.parametrize("chunk", [0, 4])
def test_musicgen_dense_engine_matches_jax(music, chunk):
    kw = dict(n_slots=2, max_len=48, prefill_chunk=chunk)
    jeng = JEngine(music.jp, music.jcfg, **kw)
    teng = ContinuousBatchingEngine(music.tp, music.tcfg, device="cpu", **kw)
    jreqs = _serve(jeng, music.requests, 5, True)
    treqs = _serve(teng, music.requests, 5, False)
    _assert_same(jreqs, treqs, jeng, teng)
    assert all(len(tok) == music.tcfg.n_codebooks
               for r in treqs for tok in r.out_tokens)


# --------------------------------------------------------------------- #
# Paged engine
# --------------------------------------------------------------------- #
def _paged_pair(vlm, kv="fp", **kw):
    kw = dict(dict(n_slots=2, max_len=64, paged=True, block_size=8), **kw)
    jcfg = vlm.jcfg.with_overrides(arch_type="dense", kv_cache_precision=kv)
    tcfg = vlm.tcfg.with_overrides(kv_cache_precision=kv)
    return (JEngine(vlm.jp, jcfg, **kw),
            ContinuousBatchingEngine(vlm.tp, tcfg, device="cpu", **kw))


@pytest.mark.parametrize("kv", ["fp", "int8", "int4"])
def test_vlm_paged_engine_matches_jax(vlm, kv):
    jeng, teng = _paged_pair(vlm, kv)
    jreqs = _serve(jeng, vlm.requests, 5, True)
    treqs = _serve(teng, vlm.requests, 5, False)
    _assert_same(jreqs, treqs, jeng, teng)
    assert teng.metrics()["prefix_hit_tokens"] == 0
    assert teng.kv.alloc.in_use == 0 and teng.kv.alloc.n_cached == 0
    if kv == "fp":
        # the JAX dense engine gives the same streams
        dense = JEngine(vlm.jp, vlm.jcfg, n_slots=2, max_len=64)
        assert [r.out_tokens for r in _serve(dense, vlm.requests, 5, True)] \
            == [r.out_tokens for r in treqs]


def test_vlm_paged_engine_preempts_like_jax(vlm):
    """A pool of 9 blocks for two 8-row frontends plus prompts: requests
    are preempted and resume by re-prefilling patches + prompt + tokens."""
    jeng, teng = _paged_pair(vlm, n_blocks=9)
    jreqs = _serve(jeng, vlm.requests, 12, True)
    treqs = _serve(teng, vlm.requests, 12, False)
    _assert_same(jreqs, treqs, jeng, teng)
    assert teng.metrics()["preempted"] > 0


def test_vlm_over_long_request_rejected_like_jax(vlm):
    """The paged engine counts the frontend rows against ``max_len``: a
    prompt that fits alone but not with its 8 patch rows is rejected at
    submit, exactly where the JAX engine rejects it."""
    nf = vlm.tcfg.n_frontend_tokens
    t, f = vlm.requests[1]
    long = np.resize(t, (1, 64 - nf - 4 + 1))     # + 4 new tokens > 64
    fits = np.resize(t, (1, 64 - nf - 4))
    reqs = [(fits, f), (long, f), vlm.requests[0]]
    jeng, teng = _paged_pair(vlm)
    jreqs = _serve(jeng, reqs, 4, True)
    treqs = _serve(teng, reqs, 4, False)
    _assert_same(jreqs, treqs, jeng, teng)
    assert [r.status for r in treqs] == ["done", "rejected", "done"]
    assert teng.metrics()["rejected"] == 1


def test_frontend_refusals_match_jax(vlm, music):
    """What stays refused: speculation (every frontend), a prefill worker
    (its blocks could not be hashed) and musicgen's paged cache, with the
    JAX package's reasons; a vlm's paged cache is served here."""
    assert paged_supported(vlm.tcfg) is None
    assert j_paged(vlm.jcfg) is not None
    assert paged_supported(music.tcfg) == j_paged(music.jcfg) is not None
    for pair in (vlm, music):
        assert spec_supported(pair.tcfg, pair.tcfg, 3) == \
            j_spec(pair.jcfg, pair.jcfg, 3) is not None
    _, teng = _paged_pair(vlm)
    with pytest.raises(ValueError, match="cannot hash prompt blocks"):
        teng.submit_prefill(vlm.requests[0][0])
