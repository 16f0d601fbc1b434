"""musicgen (the audio conditioning stub and its K codebooks) in the port
against the JAX package, on the smoke config (2 codebooks) with a float32
override and weights bridged from JAX: the config, logits ``[B, S, K, V]``
of the forward, prefill and decode, the int8 / int4 codes and scales of
the stacked ``extra_embeds`` / ``out_heads`` leaves, greedy streams through
``generate``, a ``RequestQueue`` and the dense engine over fp, int8 and
int4 KV caches, the refusals of the paged and speculative engines, the
codebook ``lm_batch`` and one training step."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.data import lm_batch as j_lm_batch  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serving.kvcache import paged_supported as j_paged  # noqa: E402
from repro.serving.scheduler import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving.spec_decode import spec_supported as j_spec  # noqa: E402
from repro.training import OptimizerConfig as JOC  # noqa: E402
from repro.training import adamw_init as j_adamw_init  # noqa: E402
from repro.training import train_step as j_train_step  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_params, prefill)
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 InferenceSession, Pipeline, RequestQueue,
                                 SamplingParams, SpecConfig, paged_supported,
                                 sample, spec_supported)
from repro_torch.serving.sampling import _sample_row  # noqa: E402
from repro_torch.training import (OptimizerConfig, adamw_init,  # noqa: E402
                                  train_step)

ARCH = "musicgen-large"
SPECS = {"fp32": (JSpec.fp32, TSpec.fp32),
         "dynamic_int8": (JSpec.dynamic_int8, TSpec.dynamic_int8),
         "int4": (JSpec.int4, TSpec.int4)}
ATOL = 1e-4


class _Music:
    """JAX params and the same bridged into the port, plus seeded requests
    (``[1, S, K]`` prompts of several lengths with their conditioning)."""

    def __init__(self):
        self.jcfg = j_configs.smoke_config(ARCH).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(ARCH).with_overrides(
            dtype="float32")
        self.jp = j_init(jax.random.PRNGKey(0), self.jcfg)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp),
                                  self.tcfg, "cpu")
        rng = np.random.default_rng(7)
        cfg = self.jcfg
        self.requests = [
            (rng.integers(0, cfg.vocab_size, (1, n, cfg.n_codebooks)),
             rng.standard_normal((1, cfg.n_frontend_tokens,
                                  cfg.frontend_dim)).astype(np.float32))
            for n in (3, 9, 5, 14)]
        self._built = {}
        self._streams = {}

    def variant(self, name):
        if name not in self._built:
            jspec, tspec = (f() for f in SPECS[name])
            self._built[name] = (jspec.build(self.jp, self.jcfg)[0],
                                 tspec.build(self.tp, self.tcfg)[0])
        return self._built[name]

    def jax_streams(self, variant, n_new, kv="fp"):
        """The JAX dense engine's greedy streams of every request, their
        first ``n_new`` tokens (one run of 6 per variant and tier)."""
        key = (variant, kv)
        if key not in self._streams:
            jq, _ = self.variant(variant)
            cfg = self.jcfg.with_overrides(kv_cache_precision=kv)
            eng = JEngine(jq, cfg, n_slots=2, max_len=48)
            reqs = [eng.submit(jnp.asarray(t), 6,
                               frontend_embeds=jnp.asarray(f))
                    for t, f in self.requests]
            eng.run()
            assert all(r.done for r in reqs)
            self._streams[key] = [r.out_tokens for r in reqs]
        return [s[:n_new] for s in self._streams[key]]


@pytest.fixture(scope="module")
def music():
    return _Music()


def _batch(music, jax_side, b=2, s=6, seed=3):
    rng = np.random.default_rng(seed)
    cfg = music.jcfg
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (b, s, cfg.n_codebooks)),
             "frontend_embeds": rng.standard_normal(
                 (b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(
                     np.float32)}
    conv = jnp.asarray if jax_side else torch.as_tensor
    return {k: conv(v) for k, v in batch.items()}


# --------------------------------------------------------------------- #
# Config and params
# --------------------------------------------------------------------- #
def test_config_matches_jax_and_nothing_is_unported():
    for get in ("get_config", "smoke_config"):
        j = getattr(j_configs, get)(ARCH)
        t = getattr(t_configs, get)(ARCH)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    full = t_configs.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size,
            full.n_codebooks, full.frontend, full.frontend_dim,
            full.n_frontend_tokens, full.source) == (
        48, 2048, 32, 32, 64, 8192, 2048, 4, "audio", 1024, 64,
        "arXiv:2306.05284")
    assert t_configs.UNPORTED == frozenset()
    assert set(t_configs.CLI_ALIASES) == set(j_configs.all_arch_ids())


def test_init_params_draws_the_codebook_leaves():
    cfg = t_configs.smoke_config(ARCH)
    p = init_params(cfg, seed=4, device="cpu")
    k, v, d = cfg.n_codebooks, cfg.vocab_size, cfg.d_model
    assert tuple(p["extra_embeds"].shape) == (k - 1, v, d)
    assert tuple(p["out_heads"].shape) == (k - 1, d, v)
    assert tuple(p["frontend_proj"].shape) == (cfg.frontend_dim, d)
    assert p["out_heads"].dtype == torch.bfloat16
    again = init_params(cfg, seed=4, device="cpu")
    assert torch.equal(p["out_heads"], again["out_heads"])
    # the JAX tree's leaves, shape for shape, so the bridge carries them
    jp = j_init(jax.random.PRNGKey(0), j_configs.smoke_config(ARCH))
    assert {key: tuple(np.shape(jp[key])) for key in jp
            if key not in ("layers",)} == \
        {key: tuple(p[key].shape) for key in p if key != "layers"}


# --------------------------------------------------------------------- #
# Logits
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", list(SPECS))
def test_forward_prefill_decode_logits_match_jax(music, variant):
    jq, tq = music.variant(variant)
    jb, tb = _batch(music, True), _batch(music, False)
    cfg = music.jcfg
    jl, _ = j_forward(jq, jb, cfg)
    tl, _ = forward(tq, tb, music.tcfg)
    assert tl.shape == (2, 6 + cfg.n_frontend_tokens, cfg.n_codebooks,
                        cfg.vocab_size)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    jl, jc = j_prefill(jq, jb, cfg, pad_to=32)
    tl, tc = prefill(tq, tb, music.tcfg, pad_to=32)
    assert tl.shape == (2, 1, cfg.n_codebooks, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=ATOL)
    rng = np.random.default_rng(11)
    pos = 6 + cfg.n_frontend_tokens
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1, cfg.n_codebooks))
        jl, jc = j_decode(jq, jc, jnp.asarray(nxt), pos + step, cfg)
        tl, tc = decode_step(tq, tc, torch.as_tensor(nxt), pos + step,
                             music.tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL, err_msg=f"decode {step}")


@pytest.mark.parametrize("variant", ["dynamic_int8", "int4"])
@pytest.mark.parametrize("leaf", ["extra_embeds", "out_heads"])
def test_codebook_leaf_codes_and_scales_bit_identical(music, variant, leaf):
    jq, tq = music.variant(variant)
    leaf_t, leaf_j = tq[leaf], jq[leaf]
    assert set(leaf_t) == set(leaf_j)
    codes = "w_int4" if variant == "int4" else "w_int8"
    assert leaf_t[codes].shape == tuple(np.shape(music.jp[leaf]))
    for key in (codes, "scale"):
        np.testing.assert_array_equal(leaf_t[key].numpy(),
                                      np.asarray(leaf_j[key]))
    # codebook 0's leaves follow the same rules
    for key in (codes, "scale"):
        np.testing.assert_array_equal(tq["unembed"][key].numpy(),
                                      np.asarray(jq["unembed"][key]))


# --------------------------------------------------------------------- #
# Sampling
# --------------------------------------------------------------------- #
def test_sample_takes_codebook_logits():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((3, 50), generator=gen)
    greedy = sample(logits, SamplingParams(), 0)
    assert greedy.tolist() == torch.argmax(logits, dim=-1).tolist()
    sp = SamplingParams(temperature=0.8, top_k=10, seed=5)
    draws = sample(logits, sp, 4)
    assert draws.shape == (3,) and draws.dtype == torch.int64
    assert torch.equal(draws, sample(logits, sp, 4))
    # codebook k draws from its own generator, seeded from (seed, token
    # index, k): the same row in every codebook gives independent streams
    for k in range(3):
        row = _sample_row(logits[k], sp, sp.generator_for(4, "cpu", k))
        assert int(draws[k]) == int(row)
        assert int(draws[k]) in torch.topk(logits[k], 10).indices.tolist()
    same = logits[0].expand(3, 50)
    seqs = {tuple(int(sample(same, sp, i)[k]) for i in range(40))
            for k in range(3)}
    assert len(seqs) == 3, "codebooks share one random stream"


# --------------------------------------------------------------------- #
# Greedy streams
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", list(SPECS))
def test_generate_matches_the_jax_engine(music, variant):
    """``generate`` feeds every codebook's argmax back ([B, 1, K] a step).
    The JAX package's ``generate`` reads one codebook only (its
    ``last[..., -1, :]`` indexes the codebook axis; ROADMAP Queue 3), so
    the port is held to the JAX engine's streams, which carry all K."""
    want = music.jax_streams(variant, 5)
    _, tq = music.variant(variant)
    sess = InferenceSession(tq, music.tcfg, device="cpu")
    for (t, f), stream in zip(music.requests, want):
        got = sess.generate({"tokens": torch.as_tensor(t),
                             "frontend_embeds": torch.as_tensor(f)}, 5)
        assert got.shape == (1, 5, music.tcfg.n_codebooks)
        assert got[0].tolist() == stream


def test_request_queue_serves_codebook_streams(music):
    want = music.jax_streams("fp32", 4)
    sess = InferenceSession(music.tp, music.tcfg, device="cpu")
    queue = RequestQueue(Pipeline(lambda raw: raw,
                                  lambda batch: sess.generate(batch, 4),
                                  lambda out, raw: out), max_batch=1)
    reqs = [queue.submit({"tokens": torch.as_tensor(t),
                          "frontend_embeds": torch.as_tensor(f)})
            for t, f in music.requests]
    queue.drain()
    assert [r.result[0].tolist() for r in reqs] == want


@pytest.mark.parametrize("kv", ["fp", "int8", "int4"])
@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_dense_engine_streams_match_jax(music, variant, kv):
    want = music.jax_streams(variant, 6, kv=kv)
    _, tq = music.variant(variant)
    cfg = music.tcfg.with_overrides(kv_cache_precision=kv)
    eng = ContinuousBatchingEngine(tq, cfg, n_slots=2, max_len=48,
                                   device="cpu")
    assert tuple(eng.last_tokens.shape) == (2, 1, cfg.n_codebooks)
    reqs = [eng.submit(t, 6, frontend_embeds=f) for t, f in music.requests]
    eng.run()
    assert [r.out_tokens for r in reqs] == want
    m = eng.metrics()
    assert m["completed"] == len(reqs) and m["prefix_hit_tokens"] == 0


def test_chunked_prefill_and_codebook_eos_match_jax(music):
    """A chunked prefill (the tail of [K] prompt tokens rides decode) and a
    per-codebook EOS tuple taken from the stream itself: both engines stop
    at the same token."""
    stream = music.jax_streams("fp32", 6)[1]
    eos = tuple(stream[2])
    jeng = JEngine(music.jp, music.jcfg, n_slots=2, max_len=48,
                   prefill_chunk=4)
    teng = ContinuousBatchingEngine(music.tp, music.tcfg, n_slots=2,
                                    max_len=48, prefill_chunk=4,
                                    device="cpu")
    pairs = []
    for i, (t, f) in enumerate(music.requests):
        e = eos if i == 1 else -1
        pairs.append((jeng.submit(jnp.asarray(t), 6,
                                  frontend_embeds=jnp.asarray(f), eos_id=e),
                      teng.submit(t, 6, frontend_embeds=f, eos_id=e)))
    jeng.run()
    teng.run()
    assert [t.out_tokens for _, t in pairs] == \
        [j.out_tokens for j, _ in pairs]
    assert pairs[1][1].out_tokens[-1] == list(eos)
    assert len(pairs[1][1].out_tokens) == 3
    for key in ("decode_steps", "prefill_tokens", "prompt_tokens_computed",
                "generated_tokens"):
        assert teng.metrics()[key] == jeng.metrics()[key], key
    teng.warmup()      # a zero [1, s, K] prompt, then every counter reset
    assert teng.metrics()["submitted"] == 0


def test_engine_checks_the_codebook_axis(music):
    eng = ContinuousBatchingEngine(music.tp, music.tcfg, n_slots=1,
                                   max_len=32, device="cpu")
    with pytest.raises(ValueError, match=r"\[1, S, K\]"):
        eng.submit(np.zeros((1, 4), np.int64), 2)


# --------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------- #
def test_paged_and_spec_refuse_with_the_jax_reasons(music):
    assert paged_supported(music.tcfg) == j_paged(music.jcfg)
    assert paged_supported(music.tcfg) is not None
    with pytest.raises(ValueError) as jexc:
        JEngine(music.jp, music.jcfg, n_slots=1, max_len=32, paged=True)
    with pytest.raises(ValueError) as texc:
        ContinuousBatchingEngine(music.tp, music.tcfg, n_slots=1, max_len=32,
                                 paged=True, device="cpu")
    assert str(texc.value) == str(jexc.value)
    why = spec_supported(music.tcfg, music.tcfg, 3)
    assert why == j_spec(music.jcfg, music.jcfg, 3) and why is not None
    with pytest.raises(ValueError, match="speculative decoding unsupported"):
        ContinuousBatchingEngine(
            music.tp, music.tcfg, n_slots=1, max_len=32, device="cpu",
            spec=SpecConfig(draft=InferenceSession(music.tp, music.tcfg,
                                                   device="cpu"), k=3))


# --------------------------------------------------------------------- #
# Data and training
# --------------------------------------------------------------------- #
def test_lm_batch_codebook_tokens_match_jax():
    """Both packages lay the codebooks out the same way over their own
    base stream: codebook k is ``(tokens + 7k) % V`` and every codebook's
    last label is IGNORE."""
    jcfg = j_configs.smoke_config(ARCH)
    tcfg = t_configs.smoke_config(ARCH)
    one_j = jcfg.with_overrides(n_codebooks=0)
    one_t = tcfg.with_overrides(n_codebooks=0)
    key = jax.random.PRNGKey(5)
    jb, jb1 = j_lm_batch(key, jcfg, 3, 10), j_lm_batch(key, one_j, 3, 10)
    tb = lm_batch(torch.Generator().manual_seed(5), tcfg, 3, 10, "cpu")
    tb1 = lm_batch(torch.Generator().manual_seed(5), one_t, 3, 10, "cpu")
    assert tb["tokens"].shape == (3, 10, 2) == np.shape(jb["tokens"])
    v = jcfg.vocab_size
    for base_t, full_t, base_j, full_j in ((tb1, tb, jb1, jb),):
        for k in range(jcfg.n_codebooks):
            np.testing.assert_array_equal(
                full_t["tokens"][..., k].numpy(),
                (base_t["tokens"].numpy() + 7 * k) % v)
            np.testing.assert_array_equal(
                np.asarray(full_j["tokens"])[..., k],
                (np.asarray(base_j["tokens"]) + 7 * k) % v)
        np.testing.assert_array_equal(full_t["labels"][:, -1].numpy(),
                                      np.asarray(full_j["labels"])[:, -1])
    # the JAX batch itself through the port's own layout rule
    want = np.stack([(np.asarray(jb1["tokens"]) + 7 * k) % v
                     for k in range(jcfg.n_codebooks)], -1)
    np.testing.assert_array_equal(np.asarray(jb["tokens"]), want)
    np.testing.assert_array_equal(tb["labels"][:, :-1].numpy(),
                                  tb["tokens"][:, 1:].numpy())


def test_one_train_step_matches_jax(music):
    batch = j_lm_batch(jax.random.PRNGKey(2), music.jcfg, 2, 8)
    rng = np.random.default_rng(4)
    batch["frontend_embeds"] = jnp.asarray(rng.standard_normal(
        (2, music.jcfg.n_frontend_tokens, music.jcfg.frontend_dim)).astype(
            np.float32))
    jp, jo, jm = jax.jit(lambda p, o, b: j_train_step(
        p, o, b, music.jcfg, JOC()))(music.jp,
                                     j_adamw_init(music.jp, JOC()), batch)
    tb = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
    tp = params_from_jax(jax.tree.map(np.asarray, music.jp), music.tcfg,
                         "cpu")
    tp, to, tm = train_step(tp, adamw_init(tp, OptimizerConfig()), tb,
                            music.tcfg, OptimizerConfig())
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5, rtol=0)
    # and the next loss, on the updated params
    jl, _ = j_forward(jp, batch, music.jcfg)
    tl, _ = forward(tp, tb, music.tcfg)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-4, rtol=1e-4)
