"""The port's RG-LRU block (``repro_torch.models.rglru``) and the sliding
window's ring cache (``repro_torch.models.attention``) against the JAX
package in f32, on inputs made with numpy from a seed: ``rglru_scan``
(the log-step doubling scan against ``lax.associative_scan``, several S,
an initial state), the gates, block prefill then decode, ``_ring_or_pad``
below, at and above the window, ``decode_positions`` over the ring, the
windowed GQA decode continuing a prefill over every KV tier, and a token
older than the window changing no decode output. Float outputs are held to
1e-5 of their own largest magnitude (the scans combine in another tree
order); the ring's layout and masks are held exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import rglru as j_rec  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import rglru as t_rec  # noqa: E402

ARCH = "recurrentgemma-9b"
REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=what)


def _cfgs(**kw):
    return (j_configs.smoke_config(ARCH).with_overrides(dtype="float32", **kw),
            t_configs.smoke_config(ARCH).with_overrides(dtype="float32", **kw))


class _Rec:
    """The smoke config's RG-LRU params (non-zero biases), JAX's and
    bridged."""

    def __init__(self):
        self.jcfg, self.tcfg = _cfgs()
        jp = j_rec.init_rglru_params(jax.random.PRNGKey(5), self.jcfg)
        rng = np.random.default_rng(5)
        din = self.jcfg.d_inner
        jp = dict(jp, ba=jnp.asarray(rng.uniform(-1, 1, din), jnp.float32),
                  bi=jnp.asarray(rng.uniform(-1, 1, din), jnp.float32))
        self.jp = jp
        self.tp = jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), jp)


@pytest.fixture(scope="module")
def rec():
    return _Rec()


def test_gates_match_jax(rec):
    x = np.random.default_rng(0).standard_normal(
        (2, 5, rec.jcfg.d_inner)).astype(np.float32)
    ja, ju = j_rec._gates(rec.jp, jnp.asarray(x), rec.jcfg)
    ta, tu = t_rec._gates(rec.tp, torch.from_numpy(x), rec.tcfg)
    _close(ta, ja, what="a")
    _close(tu, ju, what="u")
    assert ta.dtype == tu.dtype == torch.float32


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(rec, s, with_h0):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, rec.jcfg.d_inner)).astype(np.float32)
    h0 = rng.standard_normal((2, rec.jcfg.d_inner)).astype(np.float32)
    jy, jh = j_rec.rglru_scan(rec.jp, jnp.asarray(x), rec.jcfg,
                              h0=jnp.asarray(h0) if with_h0 else None)
    ty, th = t_rec.rglru_scan(rec.tp, torch.from_numpy(x), rec.tcfg,
                              h0=torch.from_numpy(h0) if with_h0 else None)
    _close(ty, jy, what="y")
    _close(th, jh, what="h")
    assert th.dtype == torch.float32


def test_doubling_scan_is_the_recurrence(rec):
    """The doubling scan against the step-by-step recurrence it replaces."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 37, rec.tcfg.d_inner)).astype(np.float32))
    a, u = t_rec._gates(rec.tp, x, rec.tcfg)
    h = torch.zeros(1, rec.tcfg.d_inner)
    steps = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + u[:, t]
        steps.append(h)
    y, last = t_rec.rglru_scan(rec.tp, x, rec.tcfg)
    _close(y, torch.stack(steps, 1).numpy(), what="y")
    _close(last, h.numpy(), what="h")


@pytest.mark.parametrize("s", [1, 2, 3, 9])
def test_block_prefill_then_decode_match_jax(rec, s):
    """s = 1, 2: shorter than the conv (its state padded). Prefill's h is
    f32, decode's in the activation dtype, as in JAX."""
    rng = np.random.default_rng(10 + s)
    d = rec.jcfg.d_model
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    jo, jc = j_rec.rglru_block_prefill(rec.jp, jnp.asarray(x), rec.jcfg)
    to, tc = t_rec.rglru_block_prefill(rec.tp, torch.from_numpy(x), rec.tcfg)
    _close(to, jo, what="prefill out")
    for f in range(2):
        _close(tc[f], jc[f], what=f"cache {f}")
    for step in range(4):
        xs = rng.standard_normal((2, 1, d)).astype(np.float32)
        jo, jc = j_rec.rglru_block_decode(rec.jp, jnp.asarray(xs), jc,
                                          rec.jcfg)
        h_before = tc[0]
        to, tc = t_rec.rglru_block_decode(rec.tp, torch.from_numpy(xs), tc,
                                          rec.tcfg)
        assert tc[0] is h_before                # written in place
        _close(to, jo, what=f"decode {step}")
        for f in range(2):
            _close(tc[f], jc[f], what=f"cache {f} step {step}")


def test_bf16_h_dtypes_follow_jax():
    jcfg, tcfg = (c.with_overrides(dtype="bfloat16") for c in _cfgs())
    jp = j_rec.init_rglru_params(jax.random.PRNGKey(6), jcfg)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), jp)
    x = np.random.default_rng(6).standard_normal((1, 5, jcfg.d_model))
    _, jc = j_rec.rglru_block_prefill(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    _, tc = t_rec.rglru_block_prefill(
        tp, torch.from_numpy(x.astype(np.float32)).bfloat16(), tcfg)
    assert jc[0].dtype == jnp.float32 and tc[0].dtype == torch.float32
    assert tc[1].dtype == torch.bfloat16
    xs = torch.zeros((1, 1, jcfg.d_model), dtype=torch.bfloat16)
    _, jd = j_rec.rglru_block_decode(jp, jnp.asarray(xs.float().numpy(),
                                                     jnp.bfloat16), jc, jcfg)
    assert jd[0].dtype == jnp.bfloat16
    # the port writes decode's bf16 h into the f32 cache: the same values
    _, td = t_rec.rglru_block_decode(tp, xs, tc, tcfg)
    np.testing.assert_array_equal(
        td[0].numpy(), np.asarray(jd[0]).astype(np.float32))


# --------------------------------------------------------------------- #
# The ring cache
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("s", [3, 7, 8, 9, 16, 21])
def test_ring_or_pad_matches_jax(s):
    """window 8: below (zero-padded to 8), at, and above it (the last 8
    rows rolled so position t sits at slot t % 8); without a window the
    cache pads to pad_to."""
    t = np.arange(2 * s * 3, dtype=np.float32).reshape(2, s, 3)
    for window, pad_to in ((8, 0), (8, 32), (0, 24)):
        want = np.asarray(j_attn._ring_or_pad(jnp.asarray(t), s, window,
                                              pad_to))
        got = t_attn._ring_or_pad(torch.from_numpy(t), s, window, pad_to)
        np.testing.assert_array_equal(got.numpy(), want)
    # the reference's layout, kept: the last 8 rows rolled by -(s % 8) put
    # position t at slot (t - s - s % 8) mod 8, which is t % 8 (where
    # decode_positions looks for it) only when s % 8 is 0 or 4
    ring = t_attn._ring_or_pad(torch.from_numpy(t), s, 8, 0)
    for pos in range(max(0, s - 8), s):
        slot = (pos - s - s % 8) % 8 if s > 8 else pos
        assert torch.equal(ring[:, slot], torch.from_numpy(t[:, pos]))
        assert (slot == pos % 8) == (s <= 8 or s % 8 in (0, 4))


@pytest.mark.parametrize("window", [0, 8])
def test_decode_positions_match_jax(window):
    s_cache = 8 if window else 24
    for pos in (0, 3, 7, 8, 9, 15, 23, 40):
        jout = j_attn.decode_positions(pos, 2, s_cache, window)
        tout = t_attn.decode_positions(pos, 2, s_cache, window)
        for f, (a, b) in enumerate(zip(tout, jout)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{pos} field {f}")
    # per-sequence positions (an engine's slots)
    pv = np.array([0, 5, 8, 13, 40], np.int32)
    jout = j_attn.decode_positions(jnp.asarray(pv), 5, s_cache, window)
    tout = t_attn.decode_positions(torch.from_numpy(pv.astype(np.int64)), 5,
                                   s_cache, window)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _gqa(cfgs, seed):
    jcfg, tcfg = cfgs
    jp = j_attn.init_gqa_params(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), jp)


@pytest.mark.parametrize("tier", ["fp", "int8", "int4"])
@pytest.mark.parametrize("s", [5, 8, 19])
def test_windowed_gqa_decode_continues_prefill_like_jax(tier, s):
    """window 8 over every KV tier (int8 through ops.qdecode, int4 through
    q4decode_ref): the decode wraps the ring several times."""
    cfgs = _cfgs(kv_cache_precision=tier)
    jp, tp = _gqa(cfgs, 7)
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    jo, jc = j_attn.gqa_prefill(jp, jnp.asarray(x), jnp.arange(s), jcfg,
                                window=8)
    to, tc = t_attn.gqa_prefill(tp, torch.from_numpy(x), torch.arange(s),
                                tcfg, window=8)
    _close(to, jo, what="prefill")
    for f, (a, b) in enumerate(zip(tc, jc)):
        assert a.shape[1] == 8
        _close(a, b, what=f"cache {f}")
    for step in range(12):
        xs = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jo, jc = j_attn.gqa_decode(jp, jnp.asarray(xs), jc, s + step, jcfg,
                                   window=8)
        to, tc = t_attn.gqa_decode(tp, torch.from_numpy(xs), tc, s + step,
                                   tcfg, window=8)
        _close(to, jo, what=f"decode {step}")


def test_ring_buffer_respects_window():
    """Tokens older than the window change no decode output (the JAX
    package's test, on the port)."""
    cfgs = _cfgs()
    _, tp = _gqa(cfgs, 0)
    tcfg = cfgs[1]
    gen = torch.Generator().manual_seed(1)
    x1 = torch.randn((1, 24, tcfg.d_model), generator=gen)
    x2 = x1.clone()
    x2[:, :8] = torch.randn((1, 8, tcfg.d_model), generator=gen)
    _, c1 = t_attn.gqa_prefill(tp, x1, torch.arange(24), tcfg, window=8)
    _, c2 = t_attn.gqa_prefill(tp, x2, torch.arange(24), tcfg, window=8)
    xt = torch.randn((1, 1, tcfg.d_model), generator=gen)
    d1, _ = t_attn.gqa_decode(tp, xt, c1, 24, tcfg, window=8)
    d2, _ = t_attn.gqa_decode(tp, xt, c2, 24, tcfg, window=8)
    assert torch.equal(d1, d2)
    x3 = x1.clone()
    x3[:, 20] += 1.0                      # inside the window: it counts
    _, c3 = t_attn.gqa_prefill(tp, x3, torch.arange(24), tcfg, window=8)
    d3, _ = t_attn.gqa_decode(tp, xt, c3, 24, tcfg, window=8)
    assert not torch.equal(d1, d3)
