"""Hub relabeling of power-law matrices: the port's copy of
``hub_relabel`` (``sblas/ops/kernels/spmv_pseg.py:93-116``).

Columns go in order of descending popularity, so the hub columns that most
rows touch sit together at the front of ``x``; rows go in order of
descending degree, so rows of similar length sit side by side. On the card
the first keeps the hot part of ``X`` together in L2, the second gives
neighbouring rows of the ``spmm_csr`` kernel similar work. The kernel
splits long rows itself, so the JAX package's ``split_heavy_rows`` is not
copied.
"""

from __future__ import annotations

import numpy as np

from .formats import CSR

# hub columns counted for the identity rule: the JAX package's two hub
# panels of 128 lanes (HUB_PANELS * LANES in sblas/retile_pseg.py)
HUB_COLS = 2 * 128


def hub_relabel(a: CSR, min_hub_frac: float = 0.10):
    """(A[rowperm][:, colperm], colperm, rowperm): columns by descending
    popularity (hubs first), rows by descending degree.

    When the would-be hub columns hold < ``min_hub_frac`` of the nnz the
    matrix has no hub structure (e.g. a band matrix, where all columns are
    equally popular) and the popularity sort only destroys whatever column
    locality exists: return ``a`` and identity perms then."""
    m, n = a.shape
    pop = np.bincount(a.indices, minlength=n)
    hub_mass = int(np.sort(pop)[::-1][:HUB_COLS].sum()) if n > HUB_COLS \
        else a.nnz
    if hub_mass < min_hub_frac * max(a.nnz, 1):
        ident_c = np.arange(n, dtype=np.int64)
        ident_r = np.arange(m, dtype=np.int64)
        return a, ident_c, ident_r
    colperm = np.argsort(-pop, kind="stable").astype(np.int64)
    deg = a.row_lengths
    rowperm = np.argsort(-deg, kind="stable").astype(np.int64)
    s = a.to_scipy().tocsr()[rowperm][:, colperm].tocsr()
    s.sort_indices()
    return CSR.from_scipy(s).astype(a.dtype), colperm, rowperm
