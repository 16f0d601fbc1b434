"""The port's InferenceSession against the JAX session: greedy streams on
bridged weights, prompts that cross a bucket, the request queue, stats and
the no-CPU-fallback rule."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving.engine import InferenceSession as JSession  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api.variants import DEFAULT_VARIANTS  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.serving import (InferenceSession, InferenceStats,  # noqa: E402
                                 Pipeline, RequestQueue,
                                 interpolated_percentile)
from repro_torch.serving.kvcache import pow2_bucket  # noqa: E402

# prompt + 6 new tokens land in cache buckets 16, 32 and 64, and the
# token axis pads to 16, 32 and 32: every prompt crosses into a new bucket
PROMPT_LENS = (5, 17, 30)
N_NEW = 6


@pytest.fixture(scope="module", params=["stablelm-1.6b", "mistral-nemo-12b"])
def arch(request):
    jcfg = j_configs.smoke_config(request.param).with_overrides(
        dtype="float32")
    tcfg = t_configs.smoke_config(request.param).with_overrides(
        dtype="float32")
    jp = j_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_greedy_streams_match_jax(arch, variant):
    jcfg, tcfg, jp, tp = arch
    jspec = getattr(JSpec, variant)()
    tspec = getattr(TSpec, variant)()
    js = JSession(jspec.build(jp, jcfg)[0], jcfg)
    ts = InferenceSession(tspec.build(tp, tcfg)[0], tcfg, device="cpu")
    rng = np.random.default_rng(11)
    assert len({pow2_bucket(n + N_NEW) for n in PROMPT_LENS}) == 3
    for n in PROMPT_LENS:
        toks = rng.integers(0, jcfg.vocab_size, (2, n))
        want = np.asarray(js.generate({"tokens": jnp.asarray(toks)}, N_NEW))
        got = ts.generate({"tokens": torch.as_tensor(toks)}, N_NEW)
        assert got.shape == (2, N_NEW) and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"len {n}")


def test_request_queue_serves_mixed_lengths(arch):
    _, tcfg, _, tp = arch
    session = InferenceSession(tp, tcfg, device="cpu")
    pipe = Pipeline(preprocess=lambda raw: raw,
                    infer=lambda b: session.generate(b, 4),
                    postprocess=lambda out, raw: out)
    queue = RequestQueue(pipe, max_batch=1)
    rng = np.random.default_rng(5)
    prompts = [torch.as_tensor(rng.integers(0, tcfg.vocab_size, (1, n)))
               for n in (9, 23, 40)]
    reqs = [queue.submit({"tokens": p}) for p in prompts]
    queue.drain()
    for r, p in zip(reqs, prompts):
        assert r.done
        assert torch.equal(r.result, session.generate({"tokens": p}, 4))
    # same-length requests batch together and each gets its own row back
    queue = RequestQueue(pipe, max_batch=4)
    same = [queue.submit({"tokens": prompts[0]}) for _ in range(3)]
    assert queue.pump() == 3
    assert all(torch.equal(r.result, same[0].result) for r in same)


def test_logits_records_stats(arch):
    _, tcfg, _, tp = arch
    session = InferenceSession(tp, tcfg, device="cpu")
    out = session.logits({"tokens": torch.zeros((1, 8), dtype=torch.int64)})
    assert out.shape == (1, 8, tcfg.vocab_size) and out.dtype == torch.float32
    assert session.stats.calls == 1 and session.stats.mean_ms > 0


def test_session_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = t_configs.smoke_config("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceSession({}, cfg)


def test_default_variants_are_the_paper_trio():
    assert [v.variant for v in DEFAULT_VARIANTS] == [
        "fp32", "dynamic_int8", "static_int8"]
    with pytest.raises(ValueError, match="calib_data"):
        DEFAULT_VARIANTS[2].build({}, t_configs.smoke_config("stablelm-1.6b"))


def test_percentiles_and_stats():
    assert interpolated_percentile([], 0.5) == 0.0
    assert interpolated_percentile([1.0, 3.0], 0.5) == 2.0
    assert interpolated_percentile([3.0, 1.0], -0.1) == 1.0
    assert interpolated_percentile([1.0, 2.0, 4.0], 0.75) == 3.0
    st = InferenceStats()
    for ms in (1.0, 2.0, 3.0):
        st.record(ms)
    assert st.calls == 3 and st.mean_ms == 2.0 and st.percentile_ms(1.0) == 3.0
    st.reset()
    assert st.calls == 0 and st.percentile_ms(0.5) == 0.0
