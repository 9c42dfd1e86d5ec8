"""The port's sparse operations (``spmv`` and ``SpmvPlan`` in
:mod:`sblas_torch.ops.spmv`)."""
