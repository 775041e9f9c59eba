from repro_torch.kernels.spmv.ops import ell_fold, ell_gather_fold, ell_spmv  # noqa: F401
