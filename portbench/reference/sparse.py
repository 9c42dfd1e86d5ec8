"""A CSR matrix of the generated inputs as a torch sparse tensor in
float64, and its products."""

from __future__ import annotations

import warnings

import torch


def csr_f64(inputs: dict) -> torch.Tensor:
    """The generated matrix as a float64 torch sparse CSR tensor (a 0/1
    pattern, ``data`` None, as ones)."""
    indptr, indices = inputs["indptr"], inputs["indices"]
    data = inputs["data"]
    vals = torch.ones(indices.numel(), dtype=torch.float64,
                      device=indices.device) if data is None \
        else data.to(torch.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta state"
        return torch.sparse_csr_tensor(indptr, indices, vals,
                                       size=inputs["shape"],
                                       check_invariants=False)


def degrees(inputs: dict) -> torch.Tensor:
    """The stored entries of each row, as float64."""
    indptr = inputs["indptr"].to(torch.int64)
    return (indptr[1:] - indptr[:-1]).to(torch.float64)


def matmul(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` for ``x`` of shape ``(n,)`` or ``(n, K)``."""
    if x.dim() == 1:
        return (a @ x[:, None])[:, 0]
    return a @ x
