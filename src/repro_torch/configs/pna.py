"""PNA [arXiv:2004.05718]: 4 layers, d_hidden=75, aggregators
mean-max-min-std, scalers identity-amplification-attenuation.

Field for field as ``repro/configs/pna.py``, over the port's ``PNAConfig``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn.pna import PNAConfig


def make_config(d_in: int = 100, n_classes: int = 47) -> PNAConfig:
    return PNAConfig(d_in=d_in, d_hidden=75, n_classes=n_classes, n_layers=4)


def make_smoke_config() -> PNAConfig:
    return PNAConfig(d_in=16, d_hidden=16, n_classes=5, n_layers=2)


ARCH = ArchDef(
    arch_id="pna", family="gnn",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(GNN_SHAPES),
    model_module="repro_torch.models.gnn.pna",
)
