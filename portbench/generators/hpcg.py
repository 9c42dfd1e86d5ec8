"""HPCG's problem (``GenerateProblem`` of the HPCG reference): the
27-point stencil on an ``nx x ny x nz`` grid, row ``iz*nx*ny + iy*nx +
ix``, each row's in-grid neighbours (itself included) in ascending column
order, ``diagonal`` on the diagonal and ``off_diagonal`` elsewhere. The
matrix does not depend on the seed."""

from __future__ import annotations

import torch


def generate(cfg: dict, seed: int, device) -> dict:
    nx, ny, nz = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    dtype = getattr(torch, cfg["dtype"])
    n = nx * ny * nz
    row = torch.arange(n, device=device)
    ix, iy, iz = row % nx, (row // nx) % ny, row // (nx * ny)
    masks, offsets = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                masks.append((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                             & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
                offsets.append(dz * nx * ny + dy * nx + dx)
    mask = torch.stack(masks, dim=1)                 # (n, 27), row-major
    cols = row[:, None] + torch.tensor(offsets, device=device)[None, :]
    indices = cols[mask]
    rows = row[:, None].expand(-1, 27)[mask]
    data = torch.where(indices == rows,
                       torch.tensor(float(cfg["diagonal"]), dtype=dtype,
                                    device=device),
                       torch.tensor(float(cfg["off_diagonal"]), dtype=dtype,
                                    device=device))
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(mask.sum(dim=1), dim=0)
    return {"shape": (n, n), "indptr": indptr.to(torch.int32),
            "indices": indices.to(torch.int32), "data": data}
