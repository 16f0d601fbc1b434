"""Where a dry-run step's collective bytes and peak memory come from.

Traces one sharded ``train_4k`` step of ``--arch`` at ``--layers`` layers
(published width) on JAX's 16 x 16 production mesh over a fake world, as
``repro_torch.launch.dryrun`` does, and prints per device: the collective
bytes of each (collective, port source line) pair, and the storages alive
at the step's peak grouped by the op that made them. Host only: fake
tensors, no device::

    PYTHONPATH=src python scripts/dryrun_breakdown.py --arch stablelm-1.6b \\
        --layers 2
"""
import argparse
import collections
import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import configs as C  # noqa: E402
from repro_torch.launch import dryrun, step_analysis  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


def _site() -> str:
    """The innermost port frame below the step counter, outside the
    sharding helpers."""
    for fr in reversed(traceback.extract_stack()[:-2]):
        if "/repro_torch/" in fr.filename and not fr.filename.endswith(
                ("step_analysis.py", "sharding.py")):
            return (f"{fr.filename.split('/repro_torch/')[1]}:{fr.lineno} "
                    f"{fr.name}")
    return "?"


class BreakdownCounter(step_analysis.StepCounter):
    """A ``StepCounter`` that also keeps collective bytes by call site and
    the storages alive at the peak by the op that made them."""

    def __init__(self, arguments=()):
        super().__init__(arguments)
        self.coll = collections.Counter()
        self.calls = collections.Counter()
        self.made_by = {}
        self.at_peak = {}
        self._op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func._overloadpacket.__name__
        before = sum(self.by_op.values())
        out = super().__torch_dispatch__(func, types, args, kwargs)
        nb = sum(self.by_op.values()) - before
        if nb:
            key = (self._op, _site())
            self.coll[key] += nb
            self.calls[key] += 1
        return out

    def _track(self, out):
        fresh = [t.untyped_storage() for t in step_analysis._tensors(out)]
        fresh = [st for st in fresh if id(st) not in self._seen]
        peak = self.peak
        super()._track(out)
        for st in fresh:
            self.made_by[id(st)] = (self._op, st.nbytes())
        if self.peak > peak:
            self.at_peak = {k: self.made_by[k] for k in self._seen
                            if k in self.made_by}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    cfg = C.get_config(args.arch)
    over = {"n_layers": args.layers}
    if cfg.n_dense_layers:
        over["n_dense_layers"] = min(cfg.n_dense_layers, args.layers - 1)
    cfg = cfg.with_overrides(**over)
    counter = {}

    def analyze(fn, *a):
        c = counter["c"] = BreakdownCounter(arguments=a)
        with c:
            out = fn(*a)
        res = c.result(out)
        res["outputs"] = out
        return res

    dryrun.analyze_step = analyze
    mesh = make_production_mesh()
    res, _, _ = dryrun.trace_on_mesh(cfg, "train_4k", mesh,
                                     batch=args.batch or None,
                                     seq=args.seq or None)
    c = counter["c"]
    print(f"{args.arch} at {args.layers} layers, train_4k, (16, 16): "
          f"collective {res['collective_bytes'] / 1e9:.2f} GB, flops "
          f"{res['flops']:.3e}, peak {res['peak_bytes'] / 1e9:.2f} GB a "
          "device")
    print("collective bytes by (op, source line):")
    for (op, site), n in c.coll.most_common(args.top):
        print(f"  {n / 1e9:9.2f} GB {c.calls[(op, site)]:4d}x {op:26s} {site}")
    print("storages alive at the peak, by the op that made them:")
    by_op, count = collections.Counter(), collections.Counter()
    for op, n in c.at_peak.values():
        by_op[op] += n
        count[op] += 1
    for op, n in by_op.most_common(args.top):
        print(f"  {n / 1e9:9.2f} GB {count[op]:4d}x {op}")


if __name__ == "__main__":
    main()
