"""Synthetic matrix generators and the emulated SuiteSparse registry.

The port's own copy of the JAX package's generators: the same seeds give
the same arrays in both packages. The SuiteSparse matrices named in
BASELINE.json (cant, consph, pdb1HYS, uk-2002, twitter7) are emulated from
their published shape, nnz, degree distribution and locality, so that a run
needs no download. ``load(name_or_path)`` prefers a real ``.mtx`` file
where one exists.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

from .formats import COO, CSR, coo_to_csr, tril
from .io import read_mtx


def random_csr(
    m: int,
    n: int,
    nnz_per_row: float = 16.0,
    *,
    skew: float = 0.0,
    bandwidth: Optional[int] = None,
    seed: int = 0,
    dtype=np.float32,
) -> CSR:
    """Random CSR with controllable row-degree skew and column locality.

    ``skew=0`` gives near-uniform degrees; larger values give a lognormal
    degree spread (power-law-ish tails). ``bandwidth`` restricts columns to a
    window around the diagonal (FEM-style locality); ``None`` means uniform
    columns (graph-style scatter).
    """
    rng = np.random.default_rng(seed)
    if skew > 0:
        deg = rng.lognormal(mean=np.log(max(nnz_per_row, 1.0)), sigma=skew, size=m)
        deg = np.clip(deg.astype(np.int64), 1, n)
    else:
        deg = np.full(m, int(round(nnz_per_row)), dtype=np.int64)
        deg = np.clip(deg + rng.integers(-2, 3, size=m), 1, n)
    total = int(deg.sum())
    rows = np.repeat(np.arange(m, dtype=np.int64), deg)
    if bandwidth is None:
        cols = rng.integers(0, n, size=total)
    else:
        offs = rng.integers(-bandwidth, bandwidth + 1, size=total)
        cols = np.clip(rows * n // m + offs, 0, n - 1)
    vals = rng.standard_normal(total).astype(dtype)
    return coo_to_csr(COO((m, n), rows, cols, vals))


def banded(n: int, bandwidth: int = 4, *, seed: int = 0, dtype=np.float32) -> CSR:
    """Dense band of half-width ``bandwidth`` around the diagonal."""
    rng = np.random.default_rng(seed)
    offsets = np.arange(-bandwidth, bandwidth + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), len(offsets))
    cols = rows + np.tile(offsets, n)
    mask = (cols >= 0) & (cols < n)
    rows, cols = rows[mask], cols[mask]
    vals = rng.standard_normal(len(rows)).astype(dtype)
    return coo_to_csr(COO((n, n), rows, cols, vals))


def poisson2d(nx: int, ny: Optional[int] = None, dtype=np.float32) -> CSR:
    """5-point Laplacian on an nx-by-ny grid (SPD, ~5 nnz/row)."""
    ny = ny or nx
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix, iy = idx % nx, idx // nx
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0)]
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        jx, jy = ix + dx, iy + dy
        ok = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
        rows.append(idx[ok])
        cols.append((jy * nx + jx)[ok])
        vals.append(np.full(ok.sum(), -1.0))
    return coo_to_csr(
        COO(
            (n, n),
            np.concatenate(rows),
            np.concatenate(cols),
            np.concatenate(vals).astype(dtype),
        )
    )


def convection_diffusion(nx: int, eps: float = 0.01,
                         dtype=np.float32) -> CSR:
    """Upwind 5-point stencil for -eps*lap(u) + u_x + u_y on an nx x nx
    grid (Dirichlet). Strongly nonsymmetric for small eps: the test matrix
    of ILU(0), GMRES and BiCGSTAB (the JAX package's
    ``examples/convection_ilu.py``, built in f64 and cast to ``dtype``)."""
    import scipy.sparse as sp

    n = nx * nx
    h = 1.0 / (nx + 1)
    main = np.full(n, 4 * eps / h**2 + 2 / h)
    west = np.full(n - 1, -eps / h**2 - 1 / h)
    east = np.full(n - 1, -eps / h**2)
    south = np.full(n - nx, -eps / h**2 - 1 / h)
    north = np.full(n - nx, -eps / h**2)
    # no coupling across grid-row boundaries
    edge = np.arange(1, n) % nx == 0
    west[edge] = 0.0
    east[edge] = 0.0
    s = sp.diags([main, west, east, south, north],
                 [0, -1, 1, -nx, nx]).tocsr()
    s.sort_indices()
    return CSR.from_scipy(s).astype(dtype)


def nd_permutation_grid(nx: int, ny: Optional[int] = None) -> np.ndarray:
    """Nested-dissection elimination order for an nx-by-ny grid graph.

    Real SpTRSV benchmarks factor with fill-reducing orderings (AMD/ND) that
    create wide level sets; natural-order banded factors are fully serial
    and unrepresentative. Returns ``perm`` (elimination position -> flat
    grid index, row-major iy*nx+ix)."""
    ny = ny or nx
    out = []

    def rec(x0, x1, y0, y1):
        w, h = x1 - x0, y1 - y0
        if w <= 0 or h <= 0:
            return
        if w * h <= 4:
            for yy in range(y0, y1):
                for xx in range(x0, x1):
                    out.append(yy * nx + xx)
            return
        if w >= h:
            mid = x0 + w // 2
            rec(x0, mid, y0, y1)
            rec(mid + 1, x1, y0, y1)
            # separator column, itself dissected (1D) for a balanced tail
            rec(mid, mid + 1, y0, y1) if h <= 4 else _sep_line(
                [yy * nx + mid for yy in range(y0, y1)])
        else:
            mid = y0 + h // 2
            rec(x0, x1, y0, mid)
            rec(x0, x1, mid + 1, y1)
            _sep_line([mid * nx + xx for xx in range(x0, x1)]) if w > 4 \
                else rec(x0, x1, mid, mid + 1)

    def _sep_line(ids):
        # recursive bisection of a path graph
        if len(ids) <= 2:
            out.extend(ids)
            return
        m = len(ids) // 2
        _sep_line(ids[:m])
        _sep_line(ids[m + 1:])
        out.append(ids[m])

    rec(0, nx, 0, ny)
    perm = np.asarray(out, dtype=np.int64)
    assert len(perm) == nx * ny and len(np.unique(perm)) == nx * ny
    return perm


def poisson2d_nd(nx: int, ny: Optional[int] = None, dtype=np.float32) -> CSR:
    """5-point Laplacian, nested-dissection ordered (parallel-friendly
    Cholesky level profile — BASELINE config #3's realistic regime)."""
    a = poisson2d(nx, ny, dtype=dtype)
    perm = nd_permutation_grid(nx, ny)
    s = a.to_scipy().tocsr()[perm][:, perm].tocsr()
    s.sort_indices()
    return CSR.from_scipy(s).astype(dtype)


def spd_diag_dominant(
    n: int, nnz_per_row: float = 8.0, *, bandwidth: Optional[int] = None,
    seed: int = 0, dtype=np.float32,
) -> CSR:
    """Symmetric positive-definite-ish matrix: A = B + B^T + alpha*I."""
    b = random_csr(n, n, nnz_per_row / 2, bandwidth=bandwidth, seed=seed, dtype=np.float64)
    coo = b.tocoo()
    rows = np.concatenate([coo.row, coo.col, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([coo.col, coo.row, np.arange(n, dtype=np.int64)])
    # Diagonal dominance: diag = row-wise abs sum + 1.
    abs_sums = np.zeros(n)
    np.add.at(abs_sums, coo.row, np.abs(coo.data))
    np.add.at(abs_sums, coo.col, np.abs(coo.data))
    vals = np.concatenate([coo.data, coo.data, 2.0 * abs_sums + 1.0])
    return coo_to_csr(COO((n, n), rows, cols, vals)).astype(dtype)


def lower_triangular(
    n: int, nnz_per_row: float = 8.0, *, bandwidth: Optional[int] = None,
    skew: float = 0.0, seed: int = 0, dtype=np.float32, unit_diagonal: bool = False,
) -> CSR:
    """Well-conditioned sparse lower-triangular L with a full nonzero diagonal.

    Structure model for SpTRSV benchmarking: off-diagonal entries below the
    diagonal (optionally band-local), diagonal set diagonally dominant so
    forward substitution is numerically stable.
    """
    a = random_csr(n, n, nnz_per_row, skew=skew, bandwidth=bandwidth, seed=seed,
                   dtype=np.float64)
    lo = tril(a, k=-1)
    coo = lo.tocoo()
    diag = np.arange(n, dtype=np.int64)
    abs_sums = np.zeros(n)
    np.add.at(abs_sums, coo.row, np.abs(coo.data))
    dvals = np.ones(n) if unit_diagonal else abs_sums + 1.0
    out = coo_to_csr(
        COO(
            (n, n),
            np.concatenate([coo.row, diag]),
            np.concatenate([coo.col, diag]),
            np.concatenate([coo.data, dvals]),
        )
    )
    return out.astype(dtype)


def cholesky_factor(a: CSR, dtype=np.float32) -> CSR:
    """Exact sparse Cholesky factor L (with fill-in) of an SPD matrix, via
    scipy's LU on a symmetric permutation-free setup. For BASELINE config #3
    ("Cholesky-factor matrices"): realistic level-set depth profiles."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    m = a.to_scipy().tocsc().astype(np.float64)
    lu = spla.splu(m, permc_spec="NATURAL", diag_pivot_thresh=0.0,
                   options={"SymmetricMode": True})
    lmat = lu.L.tocsr()
    # Scale so it is a true Cholesky-like factor: L * sqrt(D)
    d = np.sqrt(np.abs(lu.U.diagonal()))
    lmat = (sp.csr_matrix(lmat) @ sp.diags(d)).tocsr()
    lmat.sort_indices()
    return CSR.from_scipy(lmat).astype(dtype)


def powerlaw_graph(
    n: int, avg_deg: float = 16.0, alpha: float = 2.1, *, seed: int = 0,
    dtype=np.float32,
) -> CSR:
    """Power-law out-degree adjacency matrix (uk-2002/twitter7 regime)."""
    rng = np.random.default_rng(seed)
    # Zipf-distributed degrees clipped to keep total nnz near n*avg_deg.
    raw = rng.zipf(alpha, size=n).astype(np.float64)
    deg = np.clip(raw * (avg_deg / raw.mean()), 1, n // 2).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    # Preferential-attachment-ish column choice: columns also Zipf-skewed.
    cols = (rng.zipf(alpha, size=len(rows)) - 1) % n
    # Zipf(2.1) puts ~64% of draws on column 0: a row of degree d would
    # draw the top hub ~0.64*d times and CSR dedup would collapse them
    # (measured: avg_deg=100 requested, 7.3 nnz/row survived). A real graph
    # links each hub once per row — spread the within-(row, col) repeat
    # occurrences across distinct columns with a prime stride, keeping one
    # hot hit per row plus a long pseudo-random tail.
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    sk = key[order]
    idx = np.arange(len(sk), dtype=np.int64)
    newrun = np.ones(len(sk), dtype=bool)
    newrun[1:] = sk[1:] != sk[:-1]
    occ = idx - np.maximum.accumulate(np.where(newrun, idx, 0))
    spread = np.empty_like(cols)
    spread[order] = (cols[order] + occ * 9973) % n
    cols = spread
    perm = rng.permutation(n)  # decorrelate hot columns from low indices
    cols = perm[cols]
    vals = np.ones(len(rows), dtype=dtype)
    return coo_to_csr(COO((n, n), rows, cols, vals))


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    n: int
    nnz: int
    kind: str  # 'fem' | 'graph' | 'tri'
    note: str = ""


# Published SuiteSparse stats (shape / nnz after symmetric expansion) that the
# emulated generators target. uk-2002 / twitter7 are scaled by default because
# the full graphs exceed this host's memory budget for preprocessing.
SUITE = {
    "cant": MatrixSpec("cant", 62451, 4007383, "fem", "FEM/cantilever, ~64 nnz/row"),
    "consph": MatrixSpec("consph", 83334, 6010480, "fem", "FEM/spheres, ~72 nnz/row"),
    "pdb1HYS": MatrixSpec("pdb1HYS", 36417, 4344765, "fem", "protein, ~119 nnz/row"),
    "shipsec1": MatrixSpec("shipsec1", 140874, 7813404, "fem", "FEM ship section"),
    "pwtk": MatrixSpec("pwtk", 217918, 11634424, "fem", "pressurized wind tunnel"),
    "uk-2002": MatrixSpec("uk-2002", 18520486, 298113762, "graph", "web crawl, power-law"),
    "twitter7": MatrixSpec("twitter7", 41652230, 1468365182, "graph", "social, extreme skew"),
}


def emulate(name: str, *, scale: float = 1.0, seed: int = 0, dtype=np.float32) -> CSR:
    """Generate a matrix matching a SuiteSparse entry's statistics.

    ``scale`` < 1 shrinks n and nnz proportionally (for memory-limited hosts);
    degree distribution and locality regime are preserved.
    """
    spec = SUITE[name]
    n = max(int(spec.n * scale), 1024)
    avg = spec.nnz / spec.n
    if spec.kind == "fem":
        # FEM matrices: clustered columns near the diagonal, mild degree spread.
        bw = max(int(avg * 2.5), 32)
        return random_csr(n, n, avg, skew=0.15, bandwidth=bw, seed=seed, dtype=dtype)
    return powerlaw_graph(n, avg_deg=avg, seed=seed, dtype=dtype)


def load(name_or_path: str, *, scale: float = 1.0, dtype=np.float32) -> CSR:
    """Load a matrix: a real .mtx path if it exists, else an emulated entry."""
    p = Path(name_or_path)
    if p.exists():
        return read_mtx(p, dtype=dtype)
    if name_or_path in SUITE:
        return emulate(name_or_path, scale=scale, dtype=dtype)
    raise FileNotFoundError(
        f"{name_or_path!r} is neither a file nor a known SUITE entry "
        f"({', '.join(SUITE)})"
    )
