"""Mamba2 (SSD) and the RG-LRU hybrid (recurrentgemma) in the port against
the JAX package on the f32 smoke configs: the configs field for field,
the bridge of the ``groups`` / ``tail`` stacks and their caches, forward /
prefill / decode logits (the hybrid over fp, int8 and int4 KV caches), the
int8 artifacts' codes and scales bit for bit, greedy streams through
``generate``, the ``RequestQueue`` and the dense engine over fp, dynamic
and static int8 weights (the hybrid over every KV tier), and the
refusals: paged and speculative engines, audio configs, and an engine
whose ``max_len`` is below the window."""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.core.quant import CalibrationSession as JCalib  # noqa: E402
from repro.core.quant import QuantConfig as JQC  # noqa: E402
from repro.core.quant import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core.quant import quantized_size_bytes as j_size  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.transformer import init_cache as j_init_cache  # noqa: E402
from repro.serving.engine import InferenceSession as JSession  # noqa: E402
from repro.serving.engine import Pipeline as JPipeline  # noqa: E402
from repro.serving.engine import RequestQueue as JQueue  # noqa: E402
from repro.serving.scheduler import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api import SpecConfig  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import (cache_from_jax, cache_to_jax,  # noqa: E402
                                params_from_jax, stack_layers)
from repro_torch.core.quant import CalibrationSession as TCalib  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQC  # noqa: E402
from repro_torch.core.quant import quantize_tree as t_quantize_tree  # noqa: E402
from repro_torch.core.quant import quantized_size_bytes as t_size  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402
from repro_torch.models import init_cache as t_init_cache  # noqa: E402
from repro_torch.models import init_params as t_init  # noqa: E402
from repro_torch.models import prefill as t_prefill  # noqa: E402
from repro_torch.models import transformer as t_transformer  # noqa: E402
from repro_torch.models.config import check_supported  # noqa: E402
from repro_torch.models.layers import place_params  # noqa: E402
from repro_torch.models.transformer import layer_caches  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 InferenceSession, Pipeline, RequestQueue)
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCHS = ["mamba2-780m", "recurrentgemma-9b"]
ATOL = 1e-4
STACKED = ("layers", "groups", "tail")
COUNTING = ("completed", "submitted", "decode_steps", "generated_tokens",
            "prefill_tokens", "prompt_tokens_computed",
            "kv_hbm_bytes_per_req")


def _port_path(jpath: str, i: int) -> str:
    root = jpath.split("/")[0]
    return jpath.replace(f"{root}/", f"{root}/{i}/", 1)


class _Pair:
    """One arch in f32: JAX params and the same weights bridged, and its
    int8 variants built on each side."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.jp = j_init(jax.random.PRNGKey(0), self.jcfg)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp),
                                  self.tcfg, "cpu")
        rng = np.random.default_rng(1)
        self.calib = [rng.integers(0, self.jcfg.vocab_size, (2, 24))
                      for _ in range(2)]
        self._variants = {"fp32": (self.jp, self.tp)}

    def act_scales(self):
        """Both packages' calibrated activation scales, JAX's per-layer
        lists spelled as the port's per-layer paths."""
        qj, qt = JQC(mode="static_int8"), TQC(mode="static_int8")
        js, ts = JCalib(self.jp, qj), TCalib(self.tp, qt)
        for c in self.calib:
            jax.block_until_ready(j_forward(
                js.instrumented_params, {"tokens": jnp.asarray(c)},
                self.jcfg)[0])
            t_forward(ts.instrumented_params, {"tokens": torch.as_tensor(c)},
                      self.tcfg)
        j_scales, want = {}, {}
        for p, v in js.act_scales().items():
            if p.split("/")[0] in STACKED:
                j_scales[p] = v if isinstance(v, list) else [v]
                for i, vi in enumerate(j_scales[p]):
                    want[_port_path(p, i)] = vi
            else:
                j_scales[p] = want[p] = v
        return j_scales, want, ts.act_scales()

    def variant(self, name):
        if name not in self._variants:
            if name == "static_int8":
                j_scales, want, _ = self.act_scales()
                jq, _ = j_quantize_tree(self.jp, JQC(mode="static_int8"),
                                        j_scales)
                tq, _ = t_quantize_tree(self.tp, TQC(mode="static_int8"),
                                        want)
            else:
                jq, _ = JSpec.dynamic_int8().build(self.jp, self.jcfg)
                tq, _ = TSpec.dynamic_int8().build(self.tp, self.tcfg)
            self._variants[name] = (jq, tq)
        return self._variants[name]

    def cfgs(self, kv="fp"):
        return (self.jcfg.with_overrides(kv_cache_precision=kv),
                self.tcfg.with_overrides(kv_cache_precision=kv))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _Pair(request.param)


def _kv_tiers(pair):
    return ("fp", "int8", "int4") if pair.tcfg.arch_type == "hybrid" \
        else ("fp",)


# --------------------------------------------------------------------- #
# configs and the bridge
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_jax_and_param_count(arch):
    for get in ("get_config", "smoke_config"):
        j = getattr(j_configs, get)(arch)
        t = getattr(t_configs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        check_supported(t)
        assert t.param_count() == j.param_count()
        assert t.layer_types() == j.layer_types()
        assert t.for_long_context() == t
        assert dataclasses.asdict(t.for_long_context()) == \
            dataclasses.asdict(j.for_long_context())
    cfg = t_configs.get_config(arch)
    if arch == "mamba2-780m":
        assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_nheads,
                cfg.ssm_headdim, cfg.ssm_state, cfg.vocab_size) == (
            48, 1536, 3072, 48, 64, 128, 50280)
        assert cfg.tie_embeddings
    else:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.resolved_head_dim, cfg.window, cfg.d_ff,
                cfg.vocab_size) == (38, 4096, 16, 1, 256, 2048, 12288, 256000)
    # a dense model's long-context variant takes a window
    nemo = t_configs.get_config("mistral-nemo-12b")
    assert nemo.for_long_context().window == nemo.long_context_window
    assert dataclasses.asdict(nemo.for_long_context()) == dataclasses.asdict(
        j_configs.get_config("mistral-nemo-12b").for_long_context())


def test_bridge_builds_the_stacks(pair):
    tp, cfg = pair.tp, pair.tcfg
    assert ("unembed" in tp) != cfg.tie_embeddings
    if cfg.arch_type == "hybrid":
        assert len(tp["groups"]) == 1 and len(tp["tail"]) == 1
        assert set(tp["groups"][0]) == {"rec1", "rec2", "attn"}
        assert "rec" in tp["tail"][0] and "mlp" in tp["tail"][0]
    else:
        assert len(tp["layers"]) == cfg.n_layers and "ssm" in tp["layers"][0]
    own = t_init(cfg, seed=0, device="cpu")
    assert {p: tuple(t.shape) for p, t in leaves_with_path(own)} == {
        p: tuple(t.shape) for p, t in leaves_with_path(tp)}
    # back to the JAX layout, leaf for leaf
    back = dict(leaves_with_path(stack_layers(tp)))
    want = dict(leaves_with_path(jax.tree.map(np.asarray, pair.jp)))
    assert set(back) == set(want)
    for path, leaf in back.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)


def test_cache_bridge_round_trips(pair):
    for kv in _kv_tiers(pair):
        jcfg, tcfg = pair.cfgs(kv)
        jc = jax.tree.map(np.asarray, j_init_cache(jcfg, 2, 40))
        tc = cache_from_jax(jc, "cpu")
        own = t_init_cache(tcfg, 2, 40, device="cpu")
        assert [tuple(t.shape) for c in layer_caches(own) for t in c] == [
            tuple(t.shape) for c in layer_caches(tc) for t in c]
        assert [t.dtype for c in layer_caches(own) for t in c] == [
            t.dtype for c in layer_caches(tc) for t in c]
        back = cache_to_jax(tc)
        flat = dict(leaves_with_path(back))
        assert set(flat) == set(dict(leaves_with_path(jc)))
        for path, leaf in leaves_with_path(jc):
            np.testing.assert_array_equal(flat[path], leaf)
    if pair.tcfg.arch_type == "hybrid":
        # the ring holds min(seq_len, window) slots; rec1, rec2, attn in turn
        caches = t_init_cache(pair.tcfg, 1, 40, device="cpu")
        assert caches["groups"][0]["attn"][0].shape[1] == pair.tcfg.window
        assert [len(c) for c in layer_caches(caches)] == [2, 2, 2, 2]


# --------------------------------------------------------------------- #
# int8 artifacts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["dynamic_int8", "static_int8"])
def test_quantize_tree_codes_and_scales_bit_identical(pair, mode):
    """The same leaves as JAX (``rec/wa``, ``rec/wi``, ``conv_w``, ``lam``,
    ``A_log`` and ``dt_bias`` stay fp; a rec block's ``mlp/wi`` is
    quantized), codes and scales bit for bit; the tied embedding stays
    unpacked on a packing placement."""
    if mode == "static_int8":
        jq, tq = pair.variant(mode)
    else:
        jq, jpaths = j_quantize_tree(pair.jp, JQC())
        tq, tpaths = t_quantize_tree(pair.tp, TQC())
        assert sorted(tpaths) == sorted(
            [p for p in jpaths if p.split("/")[0] not in STACKED]
            + [_port_path(p, i) for p in jpaths
               if p.split("/")[0] in STACKED
               for i in range(len(pair.tp[p.split("/")[0]]))])
        if pair.tcfg.arch_type == "hybrid":
            assert "groups/0/rec1/mlp/wi" in tpaths
            assert "tail/0/mlp/wi" in tpaths
            assert not any(p.endswith(("rec/wi", "rec/wa", "conv_w", "lam"))
                           for p in tpaths)
        else:
            assert "layers/0/ssm/w_in" in tpaths
            assert not any(p.endswith(("A_log", "dt_bias", "conv_w"))
                           for p in tpaths)
        assert "embed" in tpaths
    jflat = dict(leaves_with_path(jax.tree.map(np.asarray, jq)))
    seen = set()
    for path, leaf in leaves_with_path(tq):
        root, *rest = path.split("/")
        if root in STACKED:
            key = "/".join([root] + rest[1:])
            want = jflat[key][int(rest[0])]
        else:
            key, want = path, jflat[path]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want),
                                      err_msg=path)
        seen.add(key)
    assert seen == set(jflat)
    assert t_size(tq) == j_size(jq)
    packed = place_params(tq, "cpu", pack=True)
    assert "w_int8" in packed["embed"] and "w_packed" not in packed["embed"]


def test_calibration_act_scales_match_jax(pair):
    _, want, got = pair.act_scales()
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-5, err_msg=p)


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
j_prefill_jit = jax.jit(j_prefill, static_argnames=("cfg", "pad_to"))
j_decode_jit = jax.jit(j_decode, static_argnames=("cfg",))


def _code_flips(tc, jc):
    """int8 KV codes that differ from JAX's: K and V
    come out of f32 matmuls and RoPE in another order than XLA's, so a .5
    quotient may round the other way. Each flip is one code step."""
    flips = 0
    want = dict(leaves_with_path(jax.tree.map(np.asarray, jc)))
    for path, leaf in leaves_with_path(cache_to_jax(tc)):
        if leaf.dtype == np.int8:
            diff = np.abs(leaf.astype(np.int32) - want[path].astype(np.int32))
            assert diff.max() <= 1, path
            flips += int((diff > 0).sum())
    return flips


@contextlib.contextmanager
def _nudged_norms():
    """Every block's normalized activation times the float after 1.0 (a
    relative nudge of 2^-23 in f32: one rounding), as ``chip_smoke.py``
    sizes its card-against-CPU bounds."""
    plain = t_transformer.rms_norm
    t_transformer.rms_norm = lambda w, x, eps: plain(w, x, eps) * (
        1.0 + torch.finfo(x.dtype).eps)
    try:
        yield
    finally:
        t_transformer.rms_norm = plain


def _nudge(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8", "static_int8"])
def test_forward_prefill_decode_match_jax(pair, variant):
    """Prefill lengths 21 (mamba2's sequential SSD path: 16 does not divide
    it) and 32 (chunked; past the hybrid's window of 16, so the ring wraps
    in the prefill), 12 decode steps (the ring wraps again). Logits to
    1e-4, or to 2.5 times the port's own one-rounding nudge where that is
    larger: with int8 weights one f32 rounding that moves a row's absmax
    (or a .5 quotient) moves activation codes, and the recurrent states
    carry it into every later step, so the largest nudge so far sizes the
    bound. A quantized KV code may round the other way at a .5 quotient
    (counted: at most 2, one step each); from the first step that reads
    one on, the logits are held to 2e-3 (one code step of one element
    moves these logits by 4e-4)."""
    jq, tq = pair.variant(variant)
    for s in (21, 32):
        rng = np.random.default_rng(s)
        toks = rng.integers(0, pair.jcfg.vocab_size, (2, s))
        jb, tb = {"tokens": jnp.asarray(toks)}, {
            "tokens": torch.as_tensor(toks)}
        jl = j_forward(jq, jb, pair.jcfg)[0]
        tl, _ = t_forward(tq, tb, pair.tcfg)
        with _nudged_norms():
            nl, _ = t_forward(tq, tb, pair.tcfg)
        nudge = _nudge(nl, tl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=max(ATOL, 2.5 * nudge), rtol=0,
                                   err_msg=f"forward {s}")
        for kv in _kv_tiers(pair):
            jcfg, tcfg = pair.cfgs(kv)
            rng = np.random.default_rng(s + 1)
            jl, jc = j_prefill_jit(jq, jb, cfg=jcfg, pad_to=64)
            tl, tc = t_prefill(tq, tb, tcfg, pad_to=64)
            with _nudged_norms():
                nl, nc = t_prefill(tq, tb, tcfg, pad_to=64)
            nudge = max(nudge, _nudge(nl, tl))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=max(ATOL, 2.5 * nudge), rtol=0,
                                       err_msg=f"{kv} prefill {s}")
            read_flip = False
            for step in range(12):
                nxt = rng.integers(0, jcfg.vocab_size, (2, 1))
                jl, jc = j_decode_jit(jq, jc, jnp.asarray(nxt),
                                      jnp.int32(s + step), cfg=jcfg)
                tl, tc = t_decode(tq, tc, torch.as_tensor(nxt), s + step,
                                  tcfg)
                with _nudged_norms():
                    nl, nc = t_decode(tq, nc, torch.as_tensor(nxt),
                                      s + step, tcfg)
                nudge = max(nudge, _nudge(nl, tl))
                flips = _code_flips(tc, jc) if kv == "int8" else 0
                assert flips <= 2, flips
                read_flip = read_flip or flips > 0
                np.testing.assert_allclose(
                    tl.numpy(), np.asarray(jl),
                    atol=max(2.5 * nudge, 2e-3 if read_flip else ATOL),
                    rtol=0, err_msg=f"{kv} decode {s}+{step}")


def _streams_match(pair, variant, kv):
    jq, tq = pair.variant(variant)
    jcfg, tcfg = pair.cfgs(kv)
    js = JSession(jq, jcfg)
    ts = InferenceSession(tq, tcfg, device="cpu")
    for n, seed in ((9, 1), (23, 2)):
        toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size,
                                                    (2, n))
        jg = np.asarray(js.generate({"tokens": jnp.asarray(toks)}, 8))
        tg = ts.generate({"tokens": torch.as_tensor(toks)}, 8).numpy()
        np.testing.assert_array_equal(tg, jg, err_msg=f"{variant} {kv} {n}")
    # the queue: batch-1 requests, each a generate
    prompts = [np.random.default_rng(s).integers(0, jcfg.vocab_size, (1, n))
               for s, n in ((3, 5), (4, 17), (5, 30))]
    jpipe = JPipeline(preprocess=lambda raw: raw,
                      infer=lambda b: js.generate(b, 6),
                      postprocess=lambda out, raw: out)
    tpipe = Pipeline(preprocess=lambda raw: raw,
                     infer=lambda b: ts.generate(b, 6),
                     postprocess=lambda out, raw: out)
    jqueue, tqueue = JQueue(jpipe, max_batch=1), RequestQueue(tpipe,
                                                              max_batch=1)
    jr = [jqueue.submit({"tokens": jnp.asarray(p)}) for p in prompts]
    tr = [tqueue.submit({"tokens": torch.as_tensor(p)}) for p in prompts]
    jqueue.drain()
    tqueue.drain()
    for a, b in zip(jr, tr):
        assert b.done
        np.testing.assert_array_equal(b.result.numpy(), np.asarray(a.result))


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8", "static_int8"])
def test_generate_and_queue_streams_match_jax(pair, variant):
    for kv in _kv_tiers(pair):
        _streams_match(pair, variant, kv)


def _prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (1, n)) for n in lens]


ENGINE_MODES = {"dense": {}, "chunked": {"prefill_chunk": 4}}


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8", "static_int8"])
def test_engine_streams_match_jax(pair, variant, mode):
    """5 requests on 2 slots (idle slots decode too: their states are
    overwritten at admission); prompts up to 20 tokens and 6 new each wrap
    the hybrid's 16-slot ring."""
    jq, tq = pair.variant(variant)
    for kv in _kv_tiers(pair):
        jcfg, tcfg = pair.cfgs(kv)
        kw = dict(n_slots=2, max_len=32, **ENGINE_MODES[mode])
        je = JEngine(jq, jcfg, **kw)
        te = ContinuousBatchingEngine(tq, tcfg, device="cpu", **kw)
        prompts = _prompts(jcfg.vocab_size, (5, 13, 20, 9, 17))
        pairs = [(je.submit(jnp.asarray(p), max_new_tokens=6),
                  te.submit(torch.as_tensor(p), max_new_tokens=6))
                 for p in prompts]
        je.run()
        te.run()
        for jr, tr in pairs:
            assert tr.done and tr.out_tokens == jr.out_tokens, (kv, tr.rid)
        mj, mt = je.metrics(), te.metrics()
        assert {k: mt[k] for k in COUNTING} == {k: mj[k] for k in COUNTING}


# --------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------- #
def test_paged_and_spec_are_refused_with_jax_reasons(pair):
    tp, cfg = pair.tp, pair.tcfg
    reason = ("non-attention caches" if cfg.arch_type in ("ssm", "hybrid")
              else "ring-buffer")
    with pytest.raises(ValueError, match=f"paged=True unsupported.*{reason}"):
        ContinuousBatchingEngine(tp, cfg, device="cpu", paged=True,
                                 max_len=32)
    with pytest.raises(ValueError, match="speculative decoding unsupported"
                       f".*{reason}"):
        ContinuousBatchingEngine(tp, cfg, device="cpu", max_len=32,
                                 spec=SpecConfig(draft=(tp, cfg), k=3))
    from repro.serving.kvcache import paged_supported as j_paged
    from repro.serving.spec_decode import spec_supported as j_spec
    from repro_torch.serving import paged_supported, spec_supported

    assert paged_supported(cfg) == j_paged(pair.jcfg)
    assert spec_supported(cfg, cfg, 3) == j_spec(pair.jcfg, pair.jcfg, 3)


def test_engine_below_the_window_is_refused():
    """The reference's engine fails at admission when max_len < window
    (its ring prefill does not fit the min(max_len, window)-slot cache);
    the port refuses at construction."""
    cfg = t_configs.smoke_config("recurrentgemma-9b").with_overrides(
        dtype="float32")
    tp = t_init(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="below .*sliding window 16"):
        ContinuousBatchingEngine(tp, cfg, device="cpu", max_len=12)
    ContinuousBatchingEngine(tp, cfg, device="cpu", max_len=16)
    jcfg = j_configs.smoke_config("recurrentgemma-9b").with_overrides(
        dtype="float32")
    je = JEngine(j_init(jax.random.PRNGKey(0), jcfg), jcfg, n_slots=1,
                 max_len=12)
    je.submit(jnp.zeros((1, 4), jnp.int32), max_new_tokens=2)
    with pytest.raises((TypeError, ValueError)):
        je.run()


def test_audio_stays_unported():
    # item 9's last slice ported the audio architecture: musicgen loads and
    # the audio / codebook branches pass the port's checks
    cfg = t_configs.get_config("musicgen-large")
    assert (cfg.arch_type, cfg.n_codebooks) == ("audio", 4)
    check_supported(cfg)
    base = t_configs.smoke_config("mistral-nemo-12b")
    for ok in (base.with_overrides(frontend="audio", frontend_dim=8),
               base.with_overrides(n_codebooks=2),
               base.with_overrides(arch_type="audio")):
        check_supported(ok)
