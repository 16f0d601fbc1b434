"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller names another device. With
no CUDA device and no explicit ``device=``, they raise instead of quietly
running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raises if that is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain PyTorch path on the host")
    return dev
