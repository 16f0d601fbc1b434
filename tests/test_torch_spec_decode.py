"""The port's speculative decoding against the JAX package: ``verify_step``
and ``verify_step_paged`` over the fp, int8 and int4 KV tiers (against JAX,
and against sequential ``decode_step``, with NaN in the trash block), the
spec engine's greedy streams and counting metrics (dynamic-int8 and int4
drafts, dense and paged, preempted), paged rollback, sampled streams'
independence of the batch, rejection sampling's distribution, the support
gate's messages, and ``Deployment.spec_config`` over a registry the JAX
package published."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api import ModelArtifact as JArtifact  # noqa: E402
from repro.api.registry import ArtifactRegistry as JRegistry  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import prefill_paged as j_prefill_paged  # noqa: E402
from repro.models import verify_step as j_verify  # noqa: E402
from repro.models import verify_step_paged as j_verify_paged  # noqa: E402
from repro.serving import kvcache as j_kv  # noqa: E402
from repro.serving.scheduler import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving.spec_decode import SpecConfig as JSpecConfig  # noqa: E402
from repro.serving.spec_decode import greedy_accept as j_greedy_accept  # noqa: E402
from repro.serving.spec_decode import spec_supported as j_spec_supported  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api import Deployment, ModelArtifact, SpecConfig  # noqa: E402
from repro_torch.api.registry import ArtifactRegistry  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import cache_to_jax, params_from_jax  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import decode_step_paged as t_decode_paged  # noqa: E402
from repro_torch.models import prefill as t_prefill  # noqa: E402
from repro_torch.models import prefill_paged as t_prefill_paged  # noqa: E402
from repro_torch.models import verify_step as t_verify  # noqa: E402
from repro_torch.models import verify_step_paged as t_verify_paged  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 InferenceSession, SamplingParams)
from repro_torch.serving import kvcache as t_kv  # noqa: E402
from repro_torch.serving.kvcache import hash_prompt_blocks  # noqa: E402
from repro_torch.serving.spec_decode import (ACCEPT_TAG, DRAFT_TAG,  # noqa: E402
                                             RESIDUAL_TAG, draft_propose,
                                             greedy_accept, rejection_sample,
                                             spec_probs, spec_supported,
                                             tagged_generator)

_jit = functools.partial(jax.jit, static_argnames=("cfg",))
j_prefill_jit = jax.jit(j_prefill, static_argnames=("cfg", "pad_to"))
j_verify_jit, j_verify_paged_jit, j_prefill_paged_jit = (
    _jit(j_verify), _jit(j_verify_paged), _jit(j_prefill_paged))
TIERS = ("fp", "int8", "int4")
SPEC_COUNTS = ("spec_events", "spec_draft_tokens", "spec_accepted_tokens",
               "acceptance_rate", "accepted_tokens_per_step", "decode_steps",
               "generated_tokens", "preempted", "prefix_hit_tokens",
               "prompt_tokens_computed", "kv_blocks_peak")


class _Pair:
    """mistral-nemo's smoke config (GQA 4:2) in f32: target weights from
    JAX, bridged, and the dynamic-int8 and int4 drafts built on each side."""

    def __init__(self):
        arch = "mistral-nemo-12b"
        self.jcfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.jp = j_init(jax.random.PRNGKey(0), self.jcfg)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp),
                                  self.tcfg, "cpu")
        self.drafts = {name: (getattr(JSpec, name)().build(self.jp,
                                                          self.jcfg)[0],
                              getattr(TSpec, name)().build(self.tp,
                                                           self.tcfg)[0])
                       for name in ("dynamic_int8", "int4")}
        # a draft with unrelated f32 weights: near-random proposals, most
        # rejected; the streams must not change
        jb = j_init(jax.random.PRNGKey(99), self.jcfg)
        self.drafts["unrelated"] = (jb, params_from_jax(
            jax.tree.map(np.asarray, jb), self.tcfg, "cpu"))

    def engines(self, draft, k=3, **kw):
        jd, td = self.drafts[draft]
        kw.setdefault("n_slots", 2)
        kw.setdefault("max_len", 64)
        return (JEngine(self.jp, self.jcfg,
                        spec=JSpecConfig(draft=(jd, self.jcfg), k=k), **kw),
                ContinuousBatchingEngine(
                    self.tp, self.tcfg, device="cpu",
                    spec=SpecConfig(draft=(td, self.tcfg), k=k), **kw))


@pytest.fixture(scope="module")
def pair():
    return _Pair()


def _prompts(lens, seed=1, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (1, n)) for n in lens]


def _generate(pair, prompts, n_new):
    sess = InferenceSession(pair.tp, pair.tcfg, device="cpu")
    return [sess.generate({"tokens": torch.as_tensor(p)}, n_new)[0].tolist()
            for p in prompts]


# --------------------------------------------------------------------- #
# verify_step / verify_step_paged
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("accum", [False, True])
def test_verify_step_matches_jax_and_sequential_decode(pair, tier, accum):
    """Dense verify of M = 4 tokens at per-sequence positions: logits within
    1e-4 of JAX's verify, and of the port's own M sequential decode steps;
    the caches' written rows equal the sequential run's."""
    over = dict(kv_cache_precision=tier, opt_attn_accum=accum)
    jc, tc = pair.jcfg.with_overrides(**over), pair.tcfg.with_overrides(**over)
    prompts = _prompts((11, 7), seed=3)
    lens = [p.shape[1] for p in prompts]
    cand = np.random.default_rng(4).integers(0, 512, (2, 4))
    j_caches, t_caches, t_seq = [], [], []
    for p in prompts:
        padded = np.pad(p, ((0, 0), (0, 16 - p.shape[1])))
        _, jcache = j_prefill_jit(pair.jp, {"tokens": jnp.asarray(p)},
                                  cfg=jc, pad_to=32)
        j_caches.append(jcache)
        for dest in (t_caches, t_seq):
            with torch.no_grad():
                _, c = t_prefill(pair.tp, {"tokens": torch.as_tensor(
                    padded)}, tc, pad_to=32, n_valid=p.shape[1])
            dest.append(c)
    join = lambda cs: {"layers": [tuple(torch.cat(f) for f in zip(*ls))  # noqa: E731
                                  for ls in zip(*[c["layers"] for c in cs])]}
    j_cache = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=1),
                           *j_caches)
    t_cache, seq_cache = join(t_caches), join(t_seq)
    pos = np.asarray(lens)
    jl, j_cache = j_verify_jit(pair.jp, j_cache, jnp.asarray(cand),
                               jnp.asarray(pos, jnp.int32), cfg=jc)
    with torch.no_grad():
        tl, t_cache = t_verify(pair.tp, t_cache, torch.as_tensor(cand),
                               torch.as_tensor(pos), tc)
        seq = [t_decode(pair.tp, seq_cache, torch.as_tensor(cand[:, i:i + 1]),
                        torch.as_tensor(pos + i), tc)[0] for i in range(4)]
    assert tl.shape == (2, 4, pair.tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tl.numpy(), torch.cat(seq, 1).numpy(),
                               atol=1e-4, rtol=0)
    back, want = cache_to_jax(t_cache)["layers"], cache_to_jax(
        seq_cache)["layers"]
    for b_, w_ in zip(back, want):
        for i in range(2):
            rows = slice(0, lens[i] + 4)
            if b_.dtype == np.int8:
                assert np.abs(b_[:, i, rows].astype(int)
                              - w_[:, i, rows].astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(b_[:, i, rows].astype(np.float32),
                                           w_[:, i, rows].astype(np.float32),
                                           atol=1e-5, rtol=0)


@pytest.mark.parametrize("tier", TIERS)
def test_verify_step_paged_matches_jax_with_poisoned_trash(pair, tier):
    """Paged verify through scattered tables with a -1 tail: the port's
    logits with NaN (f32 pools, f32 / f16 scales) or -128 codes in trash
    block 0 are within 1e-4 of JAX's on a clean pool and of the port's
    dense verify; the poisoned block changes no live row."""
    jc = pair.jcfg.with_overrides(kv_cache_precision=tier)
    tc = pair.tcfg.with_overrides(kv_cache_precision=tier)
    bs, nb = 8, 12
    prompts = _prompts((13, 6), seed=5)
    lens = [p.shape[1] for p in prompts]
    tables = np.array([[7, 2, 9, -1, -1], [4, 11, -1, -1, -1]], np.int32)
    cand = np.random.default_rng(6).integers(0, 512, (2, 4))
    jpools = j_kv.init_paged_pools(jc, nb, bs)
    tpools = t_kv.init_paged_pools(tc, nb, bs, device="cpu")
    for i, p in enumerate(prompts):
        padded = np.pad(p, ((0, 0), (0, 16 - p.shape[1])))
        _, jpools = j_prefill_paged_jit(pair.jp, jpools,
                                        {"tokens": jnp.asarray(padded)},
                                        jnp.int32(lens[i]),
                                        jnp.asarray(tables[i:i + 1]), cfg=jc)
        with torch.no_grad():
            t_prefill_paged(pair.tp, tpools, {"tokens": torch.as_tensor(
                padded)}, lens[i], torch.as_tensor(tables[i:i + 1]), tc)
    for leaves in tpools["layers"]:          # poison the trash block
        for t in leaves:
            if t.is_floating_point():
                t[0] = float("nan")
            else:
                t[0] = -128
    pos = np.asarray(lens)
    jl, _ = j_verify_paged_jit(pair.jp, jpools, jnp.asarray(cand),
                               jnp.asarray(pos, jnp.int32),
                               jnp.asarray(tables), cfg=jc)
    with torch.no_grad():
        tl, _ = t_verify_paged(pair.tp, tpools, torch.as_tensor(cand),
                               torch.as_tensor(pos), torch.as_tensor(tables),
                               tc)
        seq = [t_decode_paged(pair.tp, tpools,
                              torch.as_tensor(cand[:, i:i + 1]),
                              torch.as_tensor(pos + i),
                              torch.as_tensor(tables), tc)[0]
               for i in range(4)]
    assert bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tl.numpy(), torch.cat(seq, 1).numpy(),
                               atol=1e-4, rtol=0)


# --------------------------------------------------------------------- #
# The spec engine
# --------------------------------------------------------------------- #
#: counts that do not depend on which tokens the draft proposes
STREAM_COUNTS = ("generated_tokens", "preempted", "prefix_hit_tokens",
                 "prompt_tokens_computed")


@pytest.mark.parametrize("draft", ["dynamic_int8", "int4", "unrelated"])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("k", [2, 4])
def test_spec_engine_greedy_streams_match_jax_and_generate(pair, draft,
                                                           paged, k):
    """Greedy streams token for token the JAX spec engine's and the
    target's own ``generate``. With the int4 and the unrelated f32 drafts
    (no activation quantization) every spec and counting metric equals
    JAX's. The dynamic-int8 draft quantizes each linear's input rows, so an
    activation an ulp from a rounding boundary (the f32 matmuls and RoPE
    before it round in another order) flips a code and moves the draft's
    logits by up to ~0.05 (``test_torch_chunked``): where its top two
    logits are that close, a proposal, and so the acceptance counts, may
    differ from JAX's (one proposal in 25-46 seen); the streams may not."""
    kw = dict(paged=True, block_size=8) if paged else {}
    je, te = pair.engines(draft, k=k, **kw)
    prompts = _prompts((5, 13, 20, 9), seed=1)
    jr = [je.submit(jnp.asarray(p), max_new_tokens=12) for p in prompts]
    tr = [te.submit(torch.as_tensor(p), max_new_tokens=12) for p in prompts]
    je.run()
    te.run()
    want = _generate(pair, prompts, 12)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr] == want
    jm, tm = je.metrics(), te.metrics()
    assert set(tm) == set(jm)
    for key in STREAM_COUNTS:
        assert tm[key] == jm[key], key
    assert tm["spec_events"] > 0 and 0 <= tm["acceptance_rate"] <= 1
    if draft == "dynamic_int8":
        assert abs(tm["acceptance_rate"] - jm["acceptance_rate"]) <= 0.1
        return
    for key in SPEC_COUNTS:
        assert tm[key] == jm[key], key
    assert [(r.spec_events, r.spec_accepted) for r in tr] == \
        [(r.spec_events, r.spec_accepted) for r in jr]
    if draft == "unrelated":
        assert tm["acceptance_rate"] < 0.5


def test_spec_engine_chunked_prefill_and_prefix_hits_match_jax(pair):
    """Feeds ride the verify pass (up to k+1 tokens a step): a chunked
    prompt tail on the dense engine, a prefix-hit tail on the paged one."""
    prefix = _prompts((16,), seed=7)[0]
    prompts = [np.concatenate([prefix, t], 1)
               for t in _prompts((3, 6, 9), seed=8)]
    for kw in (dict(prefill_chunk=8), dict(paged=True, block_size=8)):
        je, te = pair.engines("int4", **kw)
        jr, tr = [], []
        for p in prompts:
            jr.append(je.submit(jnp.asarray(p), max_new_tokens=8))
            tr.append(te.submit(torch.as_tensor(p), max_new_tokens=8))
            je.run()
            te.run()
        assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr] \
            == _generate(pair, prompts, 8)
        jm, tm = je.metrics(), te.metrics()
        for key in SPEC_COUNTS:
            assert tm[key] == jm[key], (kw, key)
    assert tm["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("draft", ["dynamic_int8", "int4"])
def test_paged_spec_preemption_resumes_to_generate(pair, draft):
    """A pool of 7 blocks for three requests preempts mid-speculation; every
    stream, the resumed ones included, equals the target's ``generate``
    (the port is held to ``generate``, not to the JAX engine), and the pool
    drains."""
    prompts = _prompts((10, 12, 13), seed=12)
    _, te = pair.engines(draft, n_slots=3, max_len=48, paged=True,
                         block_size=8, n_blocks=7)
    tr = [te.submit(torch.as_tensor(p), max_new_tokens=12) for p in prompts]
    te.run()
    assert te.metrics()["preempted"] > 0
    assert any(r.preemptions for r in tr)
    assert [r.out_tokens for r in tr] == _generate(pair, prompts, 12)
    assert te.kv.alloc.in_use == 0


def test_paged_rollback_frees_rejected_blocks(pair):
    """After every step each slot holds exactly the blocks its committed
    tokens need (``truncate`` freed the rejected tail), and the prefix
    registry holds only hashes of prompt blocks."""
    prompts = _prompts((9, 17, 14), seed=13)
    _, te = pair.engines("int4", k=4, n_slots=3, paged=True, block_size=4)
    for p in prompts:
        te.submit(torch.as_tensor(p), max_new_tokens=10)
    legal = set()
    for p in prompts:
        legal.update(hash_prompt_blocks(p[0].tolist(), 4))
    truncated = 0
    while te.has_work:
        before = sum(len(b) for b in te.kv.slot_blocks)
        te.step()
        for s, req in enumerate(te.active):
            if req is not None:
                assert len(te.kv.slot_blocks[s]) == \
                    te.kv.blocks_for_tokens(req.cache_pos), s
        truncated += before > sum(len(b) for b in te.kv.slot_blocks)
        assert set(te.kv.alloc._by_hash) <= legal
    assert te.metrics()["acceptance_rate"] < 1 and truncated > 0
    assert te.kv.alloc.in_use == 0


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_spec_stream_independent_of_batch(pair, paged):
    """A sampled request (temperature 0.8, top-k 20, fixed seed) gives the
    same stream alone and beside other sampled and greedy requests."""
    kw = dict(paged=True, block_size=8) if paged else {}
    sp = SamplingParams(temperature=0.8, top_k=20, seed=21)
    prompt = _prompts((11,), seed=14)[0]
    _, alone = pair.engines("dynamic_int8", n_slots=1, **kw)
    a = alone.submit(torch.as_tensor(prompt), max_new_tokens=10, sampling=sp)
    alone.run()
    _, busy = pair.engines("dynamic_int8", n_slots=3, **kw)
    others = [busy.submit(torch.as_tensor(p), max_new_tokens=7,
                          sampling=SamplingParams(temperature=1.0, seed=i)
                          if i else None)
              for i, p in enumerate(_prompts((6, 15), seed=15))]
    b = busy.submit(torch.as_tensor(prompt), max_new_tokens=10, sampling=sp)
    busy.run()
    assert a.done and b.done and all(r.done for r in others)
    assert a.out_tokens == b.out_tokens and len(a.out_tokens) == 10
    assert alone.metrics()["spec_events"] > 0


def test_rejection_sampling_follows_the_target_distribution():
    """Draft proposals from q, accepted or resampled against p: the first
    committed token over 4000 seeds fits p (chi-square below the 99.9%
    quantile for 7 degrees of freedom, ~24.3), and differs from q."""
    target = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -2.0]] * 2)
    draft = torch.tensor([-1.0, 0.0, 2.0, 0.5, 1.0, -2.0, 1.5, 0.0])
    counts = np.zeros(8)
    accepted = 0
    for seed in range(4000):
        params = SamplingParams(temperature=1.0, seed=seed)
        tok, q = draft_propose(draft, params, 0)
        n_acc, out = rejection_sample([tok], [q], target, params, 0)
        counts[out[0]] += 1
        accepted += n_acc
    p = torch.softmax(target[0], -1).numpy()
    chi2 = float(((counts - 4000 * p) ** 2 / (4000 * p)).sum())
    assert chi2 < 24.3, (chi2, counts.tolist())
    q = torch.softmax(draft, -1).numpy()
    assert float(((counts - 4000 * q) ** 2 / (4000 * q)).sum()) > 100
    overlap = float(np.minimum(p, q).sum())       # the expected accept rate
    assert abs(accepted / 4000 - overlap) < 0.03


def test_rejection_sample_identical_draft_accepts_everything():
    logits = torch.randn((4, 16), generator=torch.Generator().manual_seed(0))
    params = SamplingParams(temperature=0.8, seed=3)
    probs = [spec_probs(logits[i], params) for i in range(3)]
    drafts = [int(torch.argmax(probs[i])) for i in range(3)]
    n_acc, committed = rejection_sample(drafts, probs, logits, params, 0)
    assert n_acc == 3 and committed[:3] == drafts and len(committed) == 4


def test_tagged_streams_depend_on_seed_index_and_tag_only():
    sp = SamplingParams(temperature=1.0, seed=7)
    draws = {tag: torch.rand(4, generator=tagged_generator(sp, 5, tag, "cpu"))
             for tag in (DRAFT_TAG, ACCEPT_TAG, RESIDUAL_TAG)}
    again = torch.rand(4, generator=tagged_generator(sp, 5, DRAFT_TAG, "cpu"))
    assert torch.equal(again, draws[DRAFT_TAG])
    assert not torch.equal(draws[DRAFT_TAG], draws[ACCEPT_TAG])
    assert not torch.equal(draws[ACCEPT_TAG], draws[RESIDUAL_TAG])
    other = torch.rand(4, generator=tagged_generator(sp, 6, DRAFT_TAG, "cpu"))
    assert not torch.equal(other, draws[DRAFT_TAG])


def test_greedy_accept_matches_jax():
    for d, t in (([5, 6, 7], [5, 6, 7, 9]), ([5, 6, 7], [5, 8, 7, 9]),
                 ([5], [4, 2]), ([], [3]), ([1, 2], [1, 2, 3])):
        assert greedy_accept(d, t) == j_greedy_accept(d, t)


def test_spec_supported_gates_give_jax_messages():
    base = "mistral-nemo-12b"
    cases = [(dict(), dict(), 3), (dict(), dict(), 1),
             (dict(window=16), dict(), 3), (dict(), dict(window=16), 3),
             (dict(), dict(vocab_size=256), 3),
             (dict(n_codebooks=4), dict(), 3),
             (dict(n_experts=4, arch_type="moe"), dict(), 3),
             (dict(arch_type="ssm"), dict(), 3)]
    seen = set()
    for t_over, d_over, k in cases:
        jt = j_configs.smoke_config(base).with_overrides(**t_over)
        jd = j_configs.smoke_config(base).with_overrides(**d_over)
        tt = t_configs.smoke_config(base).with_overrides(**t_over)
        td = t_configs.smoke_config(base).with_overrides(**d_over)
        want = j_spec_supported(jt, jd, k)
        assert spec_supported(tt, td, k) == want
        seen.add(want)
    vlm = "phi-3-vision-4.2b"
    assert spec_supported(t_configs.smoke_config(vlm),
                          t_configs.smoke_config(vlm), 3) == \
        j_spec_supported(j_configs.smoke_config(vlm),
                         j_configs.smoke_config(vlm), 3)
    assert None in seen and len(seen) == len(cases)


def test_engine_refuses_unsupported_spec(pair):
    _, td = pair.drafts["dynamic_int8"]
    for spec, match in ((SpecConfig(draft=(td, pair.tcfg), k=1), "k must"),
                        (SpecConfig(draft=(td, pair.tcfg.with_overrides(
                            vocab_size=256)), k=3), "vocab mismatch"),
                        (SpecConfig(draft=(td, pair.tcfg), k=3,
                                    draft_backend="cuda"), "backend")):
        with pytest.raises(ValueError, match=match):
            ContinuousBatchingEngine(pair.tp, pair.tcfg, device="cpu",
                                     spec=spec)


def test_deployment_spec_config_over_a_jax_published_registry(tmp_path, pair):
    """The JAX package publishes fp32 and a ``draft_of="fp32"`` int4 and
    dynamic-int8 pair; the port's ``Deployment`` resolves the draft, and
    the engine it configures serves ``generate``'s streams."""
    root = str(tmp_path / "registry")
    JRegistry(root).publish_variants(
        JArtifact.create("m", "v1", pair.jp, pair.jcfg),
        [JSpec.fp32(), JSpec.int4(draft_of="fp32")])
    registry = ArtifactRegistry(root)
    ref = registry.draft_for("m", "v1")
    assert ref is not None and ref.variant == "int4"
    dep = Deployment(registry, "m")
    spec = dep.spec_config(k=3, device="cpu")
    assert spec.k == 3 and spec.draft.variant == "int4"
    assert "w_int4" in spec.draft.params["layers"][0]["mlp"]["wi"]
    target = registry.get("m", "v1", "fp32", device="cpu")
    engine = ContinuousBatchingEngine(target.params, target.config,
                                      device="cpu", spec=spec)
    prompts = _prompts((7, 12), seed=16)
    reqs = [engine.submit(torch.as_tensor(p), max_new_tokens=8)
            for p in prompts]
    engine.run()
    assert [r.out_tokens for r in reqs] == _generate(pair, prompts, 8)
    assert dep.spec_config(draft_backend="ref",
                           device="cpu").draft_backend == "ref"
    with pytest.raises(ValueError, match="backend"):
        ContinuousBatchingEngine(target.params, target.config, device="cpu",
                                 spec=dep.spec_config(draft_backend="cuda",
                                                      device="cpu"))
    with pytest.raises(KeyError, match="no draft variant"):
        dep.spec_config(target_variant="int4")
    # the port publishes the relation the same way
    ArtifactRegistry(root).publish_variants(
        ModelArtifact.create("m", "v2", pair.tp, pair.tcfg),
        [TSpec.fp32(), TSpec.dynamic_int8(draft_of="fp32")])
    jref = JRegistry(root).draft_for("m", "v2")
    assert jref is not None and jref.variant == "dynamic_int8"
