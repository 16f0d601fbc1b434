"""The port's Mamba2 SSD mixer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` in f32, on inputs made with numpy from a
seed: ``ssd_chunked`` and ``ssd_sequential`` (several chunk sizes, an
initial state threaded through), ``_segsum``, ``_causal_conv``,
``ssm_prefill`` on its chunked and its sequential path, and
``ssm_decode`` continuing a prefill. Each output is held to 1e-5 of its
own largest magnitude: the chunked einsums are taken in another order
(``(C . B) * decay`` first), so the sums agree to rounding only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

ARCH = "mamba2-780m"
REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=what)


def _ssd_inputs(seed, b, length, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, length, h)))).astype(
        np.float32) * 0.5
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    bm = rng.standard_normal((b, length, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, length, g, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a_log, bm, cm, h0


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_segsum_matches_jax_with_exact_zeros():
    x = np.random.default_rng(0).standard_normal((3, 2, 9)).astype(np.float32)
    got = t_ssm._segsum(torch.from_numpy(x))
    want = np.asarray(j_ssm._segsum(jnp.asarray(x)))
    assert torch.isneginf(got[..., 0, 1:]).all()
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], atol=1e-5,
                               rtol=0)
    assert (torch.exp(got)[..., 0, 1:] == 0).all()


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(chunk, with_h0):
    x, dt, a_log, bm, cm, h0 = _ssd_inputs(chunk, 2, 32, 4, 8, 2, 16)
    h0 = h0 if with_h0 else None
    args = (x, dt, a_log, bm, cm)
    jy, jstate = j_ssm.ssd_chunked(*_j(*args), chunk,
                                   h0=None if h0 is None else jnp.asarray(h0))
    ty, tstate = t_ssm.ssd_chunked(*_t(*args), chunk,
                                   h0=None if h0 is None
                                   else torch.from_numpy(h0))
    _close(ty, jy, what="y")
    _close(tstate, jstate, what="state")
    assert tstate.dtype == torch.float32


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_sequential_matches_jax_and_chunked(with_h0):
    x, dt, a_log, bm, cm, h0 = _ssd_inputs(5, 2, 24, 4, 8, 1, 16)
    h0t = torch.from_numpy(h0) if with_h0 else None
    args = (x, dt, a_log, bm, cm)
    jy, jstate = j_ssm.ssd_sequential(
        *_j(*args), h0=jnp.asarray(h0) if with_h0 else None)
    ty, tstate = t_ssm.ssd_sequential(*_t(*args), h0=h0t)
    _close(ty, jy, what="y")
    _close(tstate, jstate, what="state")
    # the two algorithms agree with each other (the JAX package's own
    # property test, on the port's side)
    cy, cstate = t_ssm.ssd_chunked(*_t(*args), 8, h0=h0t)
    _close(cy, ty, rel=1e-4, what="chunked vs sequential")
    _close(cstate, tstate, rel=1e-4, what="chunked vs sequential state")


def test_chunks_thread_the_state():
    """Two halves run one after the other with the first half's final
    state as h0 give the whole run's outputs."""
    x, dt, a_log, bm, cm, _ = _ssd_inputs(9, 1, 32, 4, 8, 2, 16)
    tx = _t(x, dt, a_log, bm, cm)
    whole, final = t_ssm.ssd_chunked(*tx, 8)
    first, mid = t_ssm.ssd_chunked(*(t[:, :16] if t.dim() > 1 else t
                                     for t in tx), 8)
    second, end = t_ssm.ssd_chunked(*(t[:, 16:] if t.dim() > 1 else t
                                      for t in tx), 8, h0=mid)
    _close(torch.cat([first, second], dim=1), whole.numpy(), rel=1e-5)
    _close(end, final.numpy(), rel=1e-5)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    _close(t_ssm._causal_conv(*_t(x, w)),
           j_ssm._causal_conv(*_j(x, w)))


def test_softplus_is_logaddexp():
    x = np.array([-100.0, -20.0, -1.0, 0.0, 1.0, 19.9, 20.0, 20.1, 40.0,
                  100.0], np.float32)
    got = t_ssm.softplus(torch.from_numpy(x)).numpy()
    # XLA flushes the subnormal softplus(-100) to 0; above 20 both keep
    # log1p(exp(-x)) + x, where F.softplus would return x itself
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(
        jnp.asarray(x))), rtol=2e-7, atol=1e-38)


class _Block:
    """The smoke config's SSM block params, JAX's and bridged."""

    def __init__(self):
        self.jcfg = j_configs.smoke_config(ARCH).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(ARCH).with_overrides(
            dtype="float32")
        jp = j_ssm.init_ssm_params(jax.random.PRNGKey(4), self.jcfg)
        # non-trivial D, dt_bias and norm so their broadcasts are exercised
        rng = np.random.default_rng(4)
        jp = dict(jp, D=jnp.asarray(rng.uniform(0.5, 1.5, jp["D"].shape),
                                    jnp.float32),
                  dt_bias=jnp.asarray(rng.uniform(-1, 1, jp["D"].shape),
                                      jnp.float32),
                  norm=jnp.asarray(rng.uniform(-0.5, 0.5, jp["norm"].shape),
                                   jnp.float32))
        self.jp = jp
        self.tp = jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), jp)


@pytest.fixture(scope="module")
def block():
    return _Block()


@pytest.mark.parametrize("s", [2, 3, 16, 32, 21])
def test_ssm_prefill_then_decode_match_jax(block, s):
    """s = 16 and 32: the chunked path (chunk 16); 21: the sequential path
    (16 does not divide it); 2 and 3: shorter than the conv (the conv state
    padded) and the chunk min(16, s)."""
    rng = np.random.default_rng(s)
    d = block.jcfg.d_model
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    jo, jc = j_ssm.ssm_prefill(block.jp, jnp.asarray(x), block.jcfg)
    to, tc = t_ssm.ssm_prefill(block.tp, torch.from_numpy(x), block.tcfg)
    _close(to, jo, what="prefill out")
    _close(tc[0], jc[0], what="state")
    _close(tc[1], jc[1], what="conv state")
    for step in range(4):
        xs = rng.standard_normal((2, 1, d)).astype(np.float32)
        jo, jc = j_ssm.ssm_decode(block.jp, jnp.asarray(xs), jc, block.jcfg)
        state_before = tc[0]
        to, tc = t_ssm.ssm_decode(block.tp, torch.from_numpy(xs), tc,
                                  block.tcfg)
        assert tc[0] is state_before            # written in place
        _close(to, jo, what=f"decode {step}")
        _close(tc[0], jc[0], what=f"state {step}")
        _close(tc[1], jc[1], what=f"conv state {step}")


def test_prefill_path_choice_follows_jax(block, monkeypatch):
    """The sequential path exactly where the chunk does not divide S."""
    calls = []
    real = t_ssm.ssd_sequential
    monkeypatch.setattr(t_ssm, "ssd_sequential",
                        lambda *a, **kw: calls.append(a[0].shape[1])
                        or real(*a, **kw))
    d = block.tcfg.d_model
    for s in (5, 16, 17, 32, 33, 48):
        t_ssm.ssm_prefill(block.tp, torch.zeros((1, s, d)), block.tcfg)
    chunk = block.tcfg.ssm_chunk
    assert calls == [s for s in (5, 16, 17, 32, 33, 48)
                     if s % min(chunk, s)]
