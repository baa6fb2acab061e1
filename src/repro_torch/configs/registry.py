"""Central architecture registry (port of ``repro/configs/registry.py``).

Each ported arch module defines an ``ARCH: ArchDef`` with its exact
assigned config, a reduced smoke config and its shape set. ``_MODULES``
holds only the archs the port has; an id that the reference knows and the
port does not have yet raises ``NotImplementedError`` (ROADMAP.md queue 1
item 5: the GNN and recsys archs), an unknown id
``KeyError``, as in the reference.
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
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1p1b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "greendygnn-sage": "repro_torch.configs.greendygnn_sage",
}

# the reference's other archs, still to port
_NOT_PORTED = ("pna", "mace", "gatedgcn", "nequip", "fm")

ARCHS = tuple(_MODULES)


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md queue 1 item 5); "
            f"ported: {sorted(_MODULES)}"
        )
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).ARCH
