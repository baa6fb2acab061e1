"""FM [Rendle ICDM'10]: 39 sparse fields, embed_dim=10, 2-way interactions
via the O(nk) sum-square trick. The Criteo-like vocabularies sum to
33,775,577 rows, padded to 33,775,616 (a multiple of 256, for the
reference's (data x model) row sharding).

Field for field as ``repro/configs/fm.py``, over the port's ``FMConfig``.
"""
from repro_torch.configs.registry import ArchDef
from repro_torch.configs.shapes import FM_SHAPES
from repro_torch.models.recsys.fm import CRITEO_VOCABS, FMConfig


def make_config() -> FMConfig:
    raw = sum(CRITEO_VOCABS)
    pad = -(-raw // 256) * 256
    return FMConfig(n_fields=39, embed_dim=10, pad_rows_to=pad)


def make_smoke_config() -> FMConfig:
    return FMConfig(n_fields=6, embed_dim=4, vocab_sizes=(10, 20, 5, 8, 12, 7))


ARCH = ArchDef(
    arch_id="fm", family="recsys",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=tuple(FM_SHAPES),
    model_module="repro_torch.models.recsys.fm",
)
