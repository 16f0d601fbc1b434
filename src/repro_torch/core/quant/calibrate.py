"""Static-quantization calibration: the port of
``repro.core.quant.calibrate``.

A CalibrationSession swaps every quantizable, non-embedding weight leaf for
an observer ``{"w": leaf, "obs_id": i, "obs": session}``; ``layers.linear``
then records the absmax of that linear's input activations while
representative batches run (eagerly: the observer reads the value where
the JAX package needs ``io_callback``). Each layer's leaf has its own id,
so every linear of every layer gets its own scale.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.quant.quantize import QuantConfig, quantizable
from repro_torch.tree import map_with_path

#: gathered, not multiplied: no activation to observe (static mode keeps
#: weight-only int8 for them)
_GATHERED = ("embed", "extra_embeds", "out_heads")


class CalibrationSession:
    """Usage:
        sess = CalibrationSession(params, qc)
        for batch in calib_batches:
            forward(sess.instrumented_params, batch, cfg)   # records absmax
        qparams, paths = quantize_tree(params, qc, sess.act_scales())
    """

    def __init__(self, params, qc: QuantConfig):
        self.qc = qc
        self._paths: Dict[int, str] = {}
        self._absmax: Dict[int, float] = {}

        def visit(p, leaf):
            if not quantizable(p, leaf, qc) or p.split("/")[-1] in _GATHERED:
                return leaf
            oid = len(self._paths)
            self._paths[oid] = p
            return {"w": leaf, "obs_id": oid, "obs": self}

        self.instrumented_params = map_with_path(visit, params)

    def observe(self, obs_id: int, x: torch.Tensor) -> None:
        """Called from ``layers.linear`` for observer leaves."""
        val = float(x.abs().amax().to(torch.float32))
        self._absmax[obs_id] = max(self._absmax.get(obs_id, 0.0), val)

    def act_scales(self) -> Dict[str, float]:
        """{path: absmax} for every observed leaf; a leaf never observed (or
        only ever seeing zeros) is left out and stays dynamic."""
        return {p: self._absmax[i] for i, p in self._paths.items()
                if self._absmax.get(i, 0.0) != 0.0}
