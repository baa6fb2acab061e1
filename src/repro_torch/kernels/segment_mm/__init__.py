from repro_torch.kernels.segment_mm.ops import (  # noqa: F401
    CsrFormat,
    Spmm,
    TILE,
    csr_spmm,
    csr_spmm_plain,
    to_block_sparse,
    to_csr,
    transpose_block_sparse,
    transpose_csr,
)
