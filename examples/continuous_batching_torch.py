"""Continuous-batching serving demo on the PyTorch port (the twin of
``examples/continuous_batching.py``): two backend-pinned engines (fp32 and
dynamic-int8 variants of one ModelArtifact) coexist in one process;
requests stream tokens via callbacks, mix sampling policies and
priorities, and long prompts are chunk-prefilled so they never stall
in-flight decodes. A strict queue depth shows admission control rejecting
overload.

    PYTHONPATH=src python examples/continuous_batching_torch.py
        [--device cpu]

Runs on the card by default, both engines pinned to the ``cuda`` kernel
backend; ``--device cpu`` pins them to ``ref``, the plain PyTorch path.
The weights and prompts are the port's own seeded draws.
"""
import argparse

import torch

from repro_torch import configs as C
from repro_torch.api import (ContinuousBatchingEngine, ModelArtifact,
                             SamplingParams, VariantSpec)
from repro_torch.device import resolve_device
from repro_torch.models import init_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = C.smoke_config("mistral-nemo-12b").with_overrides(dtype="float32")
    params = init_params(cfg, seed=0, device=dev)
    model = ModelArtifact.create("demo", "v1", params, cfg)
    int8_params, info = VariantSpec.dynamic_int8().build(params, cfg)
    int8 = model.with_variant("int8_dynamic", int8_params)
    backend = "cuda" if dev.type == "cuda" else "ref"
    print(f"artifacts: {model.key} + {int8.key} "
          f"({len(info['quantized_paths'])} quantized tensors), "
          f"both pinned to the {backend!r} kernel backend in one process")

    engines = {
        name: ContinuousBatchingEngine(art.params, art.config, n_slots=4,
                                       max_len=96, backend=backend,
                                       prefill_chunk=6, max_queue_depth=8,
                                       device=dev)
        for name, art in (("fp32", model), ("int8_dynamic", int8))
    }

    gen = torch.Generator().manual_seed(7)
    streamed = []
    out = {}
    for name, engine in engines.items():
        reqs = []
        for i in range(10):
            prompt = torch.randint(0, cfg.vocab_size, (1, 4 + (i % 5) * 3),
                                   generator=gen)
            sampling = (SamplingParams(temperature=0.7, top_k=20, seed=i)
                        if i % 3 == 0 else SamplingParams.greedy())
            reqs.append(engine.submit(
                prompt, max_new_tokens=4 + (i * 7) % 12,
                sampling=sampling, priority=i % 2,
                on_token=lambda r, t, name=name: streamed.append(
                    (name, r.rid, t))))
        engine.run()
        if not all(r.done for r in reqs if not r.rejected):
            raise RuntimeError(f"[{name}] an admitted request did not finish")
        m = engine.metrics(reqs)
        naive_steps = sum(r.max_new_tokens for r in reqs if not r.rejected)
        print(f"[{name}] completed {m['completed']} requests in "
              f"{engine.steps} decode steps (sequential: {naive_steps}); "
              f"chunked prefill processed {m['prefill_tokens']} prompt "
              f"tokens batch-1, the rest rode the batched decode")
        print(f"[{name}] mean TTFT {m['mean_ttft_s']*1e3:.0f} ms, "
              f"throughput {m['throughput_tok_s']:.1f} tok/s, "
              f"rejected {m['rejected']}")
        for r in reqs[:3]:
            tag = "sampled" if not r.sampling.is_greedy else "greedy"
            print(f"  req {r.rid} ({tag}, prio {r.priority}): "
                  f"prompt {r.prompt_len} toks -> {r.out_tokens}")
        out[name] = m
    print(f"streamed {len(streamed)} tokens via on_token callbacks")
    return out, streamed


if __name__ == "__main__":
    main()
