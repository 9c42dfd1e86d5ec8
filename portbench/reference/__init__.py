"""The plain reference: PyTorch operations only, on the CSR arrays the
benchmark generated. It imports nothing of ``sblas_torch`` (nor ``jax`` or
``sblas``) and takes nothing the port made: it works the transposed,
degree-scaled operator and every product out again from the generated
matrix, in float64."""
