from repro_torch.kernels.spmv.ops import (ell_fold,  # noqa: F401
                                          ell_gather_fold, ell_spmv,
                                          ell_spmv_batch)
