"""NequIP [arXiv:2101.03164]: 5 layers, mul=32, l_max=2, 8 RBF, cutoff 5,
E(3) tensor-product message passing. Non-geometric shapes use synthesized
3-D positions.

Field for field as ``repro/configs/nequip.py``, over the port's
``NequIPConfig``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn.nequip import NequIPConfig


def make_config(edge_chunk: int = 0) -> NequIPConfig:
    return NequIPConfig(n_species=32, d_hidden=32, n_layers=5, l_max=2,
                        n_rbf=8, cutoff=5.0, edge_chunk=edge_chunk)


def make_smoke_config() -> NequIPConfig:
    return NequIPConfig(n_species=8, d_hidden=8, n_layers=2, l_max=2, n_rbf=4)


ARCH = ArchDef(
    arch_id="nequip", family="gnn",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(GNN_SHAPES),
    model_module="repro_torch.models.gnn.nequip",
)
