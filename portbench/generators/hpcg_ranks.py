"""HPCG's problem over several ranks (``GenerateGeometry`` and
``GenerateProblem`` of the HPCG reference): each rank owns an ``nx x ny x
nz`` box of one global grid, the boxes stacked along z on a ``1 x 1 x
world`` process grid, so rank ``r`` owns the global grid's planes ``[r nz,
(r + 1) nz)``, which are the rows ``[r N, (r + 1) N)`` (``N = nx ny nz``) of
the global matrix in HPCG's order (row ``iz*nx*ny + iy*nx + ix``). Rank
``r`` builds those rows alone, on its card: the 27-point stencil, each
row's in-grid neighbours (itself included) in ascending column order,
``diagonal`` on the diagonal and ``off_diagonal`` elsewhere, with global
column indices; ``shape`` ``(N, world N)`` and ``row0`` ``r N``. Put
together over the ranks, the rows are :mod:`portbench.generators.hpcg`'s
matrix of the global grid. The matrix does not depend on the seed."""

from __future__ import annotations

import torch


def generate(cfg: dict, seed: int, device, rank: int = 0,
             world: int = 1) -> dict:
    if list(cfg["process_grid"]) != [1, 1, world]:
        raise ValueError(f"process grid {cfg['process_grid']} is not "
                         f"[1, 1, {world}]: the boxes stack along z")
    nx, ny, nz = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    dtype = getattr(torch, cfg["dtype"])
    rows, gz = nx * ny * nz, nz * world
    row0 = rank * rows
    row = torch.arange(row0, row0 + rows, device=device)
    ix, iy, iz = row % nx, (row // nx) % ny, row // (nx * ny)
    masks, offsets = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                masks.append((ix + dx >= 0) & (ix + dx < nx)
                             & (iy + dy >= 0) & (iy + dy < ny)
                             & (iz + dz >= 0) & (iz + dz < gz))
                offsets.append(dz * nx * ny + dy * nx + dx)
    del ix, iy, iz
    mask = torch.stack(masks, dim=1)                 # (rows, 27), row-major
    del masks
    cols = row[:, None] + torch.tensor(offsets, device=device)[None, :]
    indices = cols[mask]
    del cols
    diag = row[:, None].expand(-1, 27)[mask] == indices
    data = torch.where(diag,
                       torch.tensor(float(cfg["diagonal"]), dtype=dtype,
                                    device=device),
                       torch.tensor(float(cfg["off_diagonal"]), dtype=dtype,
                                    device=device))
    del diag
    indptr = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(mask.sum(dim=1), dim=0)
    return {"shape": (rows, rows * world), "row0": row0,
            "indptr": indptr.to(torch.int32),
            "indices": indices.to(torch.int32), "data": data}
