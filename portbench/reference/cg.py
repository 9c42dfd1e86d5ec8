"""What decides a linear solve's answer: its true relative residual
``||b - A x|| / ||b||`` in float64."""

from __future__ import annotations

import torch

from .sparse import csr_f64, matmul


def rel_residuals(inputs: dict, pairs) -> list[float]:
    """``||b - A x|| / ||b||`` of each ``(b, x)`` in ``pairs``."""
    a = csr_f64(inputs)
    out = []
    for b, x in pairs:
        b64, x64 = b.to(torch.float64), x.to(torch.float64)
        r = b64 - matmul(a, x64)
        out.append(float(torch.linalg.vector_norm(r)
                         / torch.linalg.vector_norm(b64)))
    return out


def rhs(inputs: dict, x_true: torch.Tensor) -> torch.Tensor:
    """``b = A x*`` in the matrix's dtype, for ``x*`` of shape ``(n,)`` or
    ``(n, P)`` (then ``(n, P)``)."""
    a = csr_f64(inputs)
    dtype = inputs["data"].dtype
    return matmul(a, x_true.to(torch.float64)).to(dtype)
