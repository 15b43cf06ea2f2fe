from caffe_escoin_tpu_torch.sparse.formats import (  # noqa: F401
    BSC,
    BSR,
    CSR,
    ELL,
    dense_to_bsc,
    dense_to_bsr,
    dense_to_csr,
    dense_to_ell,
)
