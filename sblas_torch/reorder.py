"""Bandwidth-reducing reordering (reverse Cuthill–McKee), the port's copy of
``sblas/reorder.py`` (``rcm``, ``unpermute``).

A matrix whose graph is mesh-like but whose numbering is scrambled gathers
``x`` from all over memory; RCM restores the band, and with it the locality
of the ``csr`` kernel's gathers. ``SpmvPlan(a, "rcm")`` runs the kernel on
``P A P^T``:

    ap, perm = sblas_torch.reorder.rcm(a)   # ap = P A P^T, symmetric perm
    y = unpermute(y_perm, perm)              # or stay in permuted space

The JAX package's ``rcm_profile`` (the w-SELL fill before and after) is not
copied: the port has no w-SELL layout to probe.
"""

from __future__ import annotations

import numpy as np

from .formats import CSR


def rcm(a: CSR) -> tuple[CSR, np.ndarray]:
    """Symmetric reverse Cuthill–McKee reordering of a square CSR matrix.

    Returns (P A P^T, perm) with ``perm[new] = old`` — i.e. apply as
    ``x_perm = x[perm]`` and ``y = y_perm_inverse`` (see ``unpermute``).
    The ordering is computed on the symmetrized pattern |A| + |A|^T.
    """
    m, n = a.shape
    if m != n:
        raise ValueError("rcm needs a square matrix")
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    s = a.to_scipy().tocsr()
    pattern = (abs(s) + abs(s).T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(pattern, symmetric_mode=True),
                      dtype=np.int64)
    sp = s[perm][:, perm].tocsr()
    sp.sort_indices()
    return CSR.from_scipy(sp).astype(a.dtype), perm


def unpermute(y_perm, perm: np.ndarray):
    """Undo the row permutation of ``rcm`` on a result vector/matrix."""
    out = np.empty_like(np.asarray(y_perm))
    out[perm] = np.asarray(y_perm)
    return out
