from repro_torch.kernels.segment_mm.ops import (  # noqa: F401
    BlockFormat,
    BlockSpmm,
    TILE,
    block_spmm,
    block_spmm_plain,
    to_block_sparse,
    transpose_block_sparse,
)
