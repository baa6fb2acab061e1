"""MACE [arXiv:2206.07697]: 2 layers, mul=128, l_max=2, correlation order 3,
8 RBF, E(3)-ACE product basis. Non-geometric shapes use synthesized 3-D
positions.

Field for field as ``repro/configs/mace.py``, over the port's
``MACEConfig``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn.mace import MACEConfig


def make_config(edge_chunk: int = 0) -> MACEConfig:
    return MACEConfig(n_species=32, d_hidden=128, n_layers=2, l_max=2,
                      correlation=3, n_rbf=8, cutoff=5.0,
                      edge_chunk=edge_chunk)


def make_smoke_config() -> MACEConfig:
    return MACEConfig(n_species=8, d_hidden=8, n_layers=2, l_max=2, n_rbf=4,
                      correlation=3)


ARCH = ArchDef(
    arch_id="mace", family="gnn",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(GNN_SHAPES),
    model_module="repro_torch.models.gnn.mace",
)
