"""GatedGCN [arXiv:2003.00982]: 16 layers, d_hidden=70, gated aggregation.

Field for field as ``repro/configs/gatedgcn.py``, over the port's
``GatedGCNConfig``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig


def make_config(d_in: int = 100, n_classes: int = 47) -> GatedGCNConfig:
    return GatedGCNConfig(d_in=d_in, d_hidden=70, n_classes=n_classes,
                          n_layers=16)


def make_smoke_config() -> GatedGCNConfig:
    return GatedGCNConfig(d_in=16, d_hidden=12, n_classes=5, n_layers=3)


ARCH = ArchDef(
    arch_id="gatedgcn", family="gnn",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(GNN_SHAPES),
    model_module="repro_torch.models.gnn.gatedgcn",
)
