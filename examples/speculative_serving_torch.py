"""Speculative decoding on the PyTorch port: an fp32 target and an int8
draft, published and paired through ``repro_torch.api``.

  1. publish fp32 + dynamic_int8 variants, the int8 one declared
     ``draft_of="fp32"``;
  2. resolve the pair into a ``SpecConfig`` with ``Deployment.spec_config``
     and serve it with ``ContinuousBatchingEngine(..., spec=...)``, dense
     and paged;
  3. check that the greedy speculative output is the target's own
     ``InferenceSession.generate`` token for token.

    PYTHONPATH=src python examples/speculative_serving_torch.py [--fast]
        [--device cpu]

Runs on the card by default, pinned to the ``cuda`` kernel backend;
``--device cpu`` pins ``ref``, the plain PyTorch path. The draft runs
under the target engine's backend.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch import configs as C
from repro_torch.api import (ArtifactRegistry, Deployment, ModelArtifact,
                             VariantSpec)
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import ContinuousBatchingEngine

ARCH = "mistral-nemo-12b"
SPEC_K = 3


def build_prompts(cfg, n, seed=23):
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(4, 17, (n,), generator=gen).tolist()
    return [torch.randint(0, cfg.vocab_size, (1, s), generator=gen)
            for s in lens]


def serve(engine, prompts, max_new):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], engine.metrics(reqs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    n = 6 if args.fast else 10
    max_new = 8 if args.fast else 12

    cfg = C.smoke_config(ARCH).with_overrides(dtype="float32")
    params = init_params(cfg, seed=0, device=dev)
    prompts = build_prompts(cfg, n)

    with tempfile.TemporaryDirectory() as root:
        dep = Deployment(ArtifactRegistry(root), model="vqi-spec")
        model = ModelArtifact.create("vqi-spec", "v1", params, cfg)
        published = dep.publish(model, specs=[
            VariantSpec.fp32(), VariantSpec.dynamic_int8(draft_of="fp32")])
        spec = dep.spec_config(target_variant="fp32", k=SPEC_K, device=dev)
        target = published["fp32"]

        # baseline: the target's own sequential generate
        backend = "cuda" if dev.type == "cuda" else "ref"
        session = target.session(backend=backend, device=dev)
        expected = [session.generate({"tokens": p}, max_new)[0].tolist()
                    for p in prompts]

        print(f"== {n} greedy requests on {dev}, fp32 target + int8 draft, "
              f"k={SPEC_K} ==")
        for label, kw in (("dense", {}),
                          ("paged", {"paged": True, "block_size": 16})):
            engine = ContinuousBatchingEngine(session, n_slots=4, max_len=96,
                                              backend=backend, spec=spec,
                                              **kw)
            out, m = serve(engine, prompts, max_new)
            assert out == expected, (
                f"{label} speculative output parted from the fp32 target's "
                "generate: greedy speculation must give its tokens")
            print(f"{label:5s}: acceptance_rate {m['acceptance_rate']:.2f}  "
                  f"accepted_tokens_per_step "
                  f"{m['accepted_tokens_per_step']:.2f}  "
                  f"decode_steps {m['decode_steps']:.0f} "
                  f"(sequential equiv {n * max_new})")
            assert m["accepted_tokens_per_step"] > 1.0, (
                "speculation should commit more than one token per verify")
        print("OK: greedy streams equal the target's, the int8 draft "
              "commits more than one token per target step")


if __name__ == "__main__":
    main()
