"""Model configurations the port serves: the config dataclasses and the
``--arch`` lookup, holding the architectures of the port's slices."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (Activation, Family, ModelConfig, Norm,
                                      PosEmb)

_ARCH_MODULES: Dict[str, str] = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
}


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


__all__ = ["Activation", "Family", "ModelConfig", "Norm", "PosEmb",
           "get_config", "list_archs"]
