"""Config registry of the port: ``get_config(arch_id)`` / ``smoke_config``.

Every architecture of the JAX package is registered: the dense-GQA
models, phi-3-vision (the VQI model family), the MoE architectures
(deepseek-v2 with MLA, kimi-k2 with GQA), Mamba2 (SSD), the RG-LRU hybrid
recurrentgemma and musicgen (audio conditioning and 4 codebooks).
"""
from __future__ import annotations

import importlib
from typing import Dict, FrozenSet, List

from repro_torch.models.config import ModelConfig

CLI_ALIASES: Dict[str, str] = {
    "deepseek-7b": "deepseek_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mamba2-780m": "mamba2_780m",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "musicgen-large": "musicgen_large",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "stablelm-1.6b": "stablelm_1_6b",
}
ARCH_IDS: List[str] = sorted(CLI_ALIASES.values())

#: the JAX package's architectures with no twin here (none since the audio
#: architecture landed)
UNPORTED: FrozenSet[str] = frozenset()


def _module(arch_id: str):
    key = CLI_ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    if key not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


def all_arch_ids() -> List[str]:
    """The CLI ids of every architecture, in ``CLI_ALIASES`` order."""
    return list(CLI_ALIASES)


#: the input shapes the dry-run traces (a copy of the JAX package's table):
#: global batch and sequence of a training step, a prefill and a decode step
INPUT_SHAPES: Dict[str, Dict[str, object]] = {
    "train_4k":    {"seq_len": 4_096,   "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32_768,  "global_batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq_len": 32_768,  "global_batch": 128, "kind": "decode"},
    "long_500k":   {"seq_len": 524_288, "global_batch": 1,   "kind": "decode"},
}
