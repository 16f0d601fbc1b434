"""Config registry of the port: ``get_config(arch_id)`` / ``smoke_config``.

The dense-GQA architectures and phi-3-vision (the VQI model family) are
registered; the other assigned architectures arrive with ROADMAP Queue 1
item 9.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

CLI_ALIASES: Dict[str, str] = {
    "mistral-nemo-12b": "mistral_nemo_12b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "stablelm-1.6b": "stablelm_1_6b",
}
ARCH_IDS: List[str] = sorted(CLI_ALIASES.values())


def _module(arch_id: str):
    key = CLI_ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    if key not in ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ROADMAP Queue 1 item 9)")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
