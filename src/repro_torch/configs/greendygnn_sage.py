"""The paper's own training model: 2-layer GraphSAGE, 16 hidden units,
fan-out {10, 25} (Section VI-A), run under the GreenDyGNN pipeline.

Field for field as ``repro/configs/greendygnn_sage.py``, over the port's
``SageConfig``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn.sage import SageConfig


def make_config(d_in: int = 602, n_classes: int = 41) -> SageConfig:
    return SageConfig(d_in=d_in, d_hidden=16, n_classes=n_classes, n_layers=2)


def make_smoke_config() -> SageConfig:
    return SageConfig(d_in=16, d_hidden=8, n_classes=5, n_layers=2)


ARCH = ArchDef(
    arch_id="greendygnn-sage", family="gnn",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(GNN_SHAPES),
    model_module="repro_torch.models.gnn.sage",
)
