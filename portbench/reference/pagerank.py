"""GAP's PageRank, and its personalized form over a batch of sources, by
power iteration in float64 on the symmetric 0/1 adjacency ``A``:

    x' = (1 - d) t + d A (x / deg),   stop when every column's
                                      ||x' - x||_1 < tol, or after max_iters

with ``t = 1/n`` everywhere (PageRank, start ``x = 1/n``) or ``t = e_s``
for source ``s`` (personalized, start ``x = e_s``). A vertex of degree 0
sends nothing, as in GAP.
"""

from __future__ import annotations

import torch

from .sparse import csr_f64, degrees, matmul


def power_iteration(inputs: dict, sources, *, damping: float, tol: float,
                    max_iters: int) -> tuple[torch.Tensor, int]:
    """``(x, iterations)``; ``sources`` None for PageRank (``x`` of shape
    ``(n,)``), else a 1-D tensor of K vertices (``x`` of shape
    ``(n, K)``)."""
    a = csr_f64(inputs)
    n = inputs["shape"][0]
    dev = inputs["indptr"].device
    deg = degrees(inputs)
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                      torch.zeros_like(deg))
    if sources is None:
        x = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    else:
        k = sources.numel()
        src, cols = sources.long(), torch.arange(k, device=dev)
        x = torch.zeros((n, k), dtype=torch.float64, device=dev)
        x[src, cols] = 1.0
    it = 0
    while it < max_iters:
        # in place where it can be: a batch's (n, K) float64 state is
        # 8.6 GB at 2**25 vertices and K = 32
        x_new = matmul(a, x * (inv if x.dim() == 1 else inv[:, None]))
        x_new.mul_(damping)
        if sources is None:
            x_new.add_((1.0 - damping) / n)
        else:
            x_new[src, cols] += 1.0 - damping
        x.sub_(x_new).abs_()
        err = x.sum(dim=0)
        x, it = x_new, it + 1
        if float(err.max()) < tol:
            break
    return x, it


def l1_gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst column's ``||x - ref||_1 / ||ref||_1``."""
    d = x.to(torch.float64, copy=True).reshape(ref.shape)
    num = d.sub_(ref).abs_().sum(dim=0)
    del d
    den = ref.abs().sum(dim=0)
    return float((num / den).max())
