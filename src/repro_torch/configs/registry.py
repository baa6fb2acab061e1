"""Central architecture registry (port of ``repro/configs/registry.py``).

Each ported arch module defines an ``ARCH: ArchDef`` with its exact
assigned config, a reduced smoke config and its shape set. ``_MODULES``
holds the reference's 11 arch ids; an unknown id raises ``KeyError``, as
in the reference.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str                      # "lm" | "gnn" | "recsys"
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: tuple                    # shape names valid for this arch
    rule_overrides: dict = dataclasses.field(default_factory=dict)
    model_module: str = ""           # import path of the model implementation
    notes: str = ""


_MODULES = {
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1p1b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "pna": "repro_torch.configs.pna",
    "mace": "repro_torch.configs.mace",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "nequip": "repro_torch.configs.nequip",
    "fm": "repro_torch.configs.fm",
    "greendygnn-sage": "repro_torch.configs.greendygnn_sage",
}

ARCHS = tuple(_MODULES)


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
