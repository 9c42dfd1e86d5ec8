"""The port's benchmark suite (:mod:`.run_suite`), the counterpart of
``benchmarks/``:

    python -m sblas_torch.benchmarks.run_suite [--quick | --large | ...]
"""
