"""Input normalization shared by the port's op entry points.

Every entry point accepts the port's ``CSR | CSC`` and a ``trans=`` flag,
and :func:`as_csr` reduces the four combinations to a CSR of the operator
actually applied. A matrix of any other class, the JAX package's included,
raises ``TypeError`` naming :func:`sblas_torch.formats.from_reference`.
Derived matrices are cached weakly per source object, so repeated calls
reuse both the host conversion and, through the plan cache keyed on the
derived CSR, its device tensors.
"""

from __future__ import annotations

import weakref

from ..formats import CSC, CSR, csr_transpose
from ..relabel import hub_relabel

# source matrix -> {"csr": CSR of A, "csr_T": CSR of A^T, "relabel": ...}
_DERIVED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def as_csr(a, trans: bool = False) -> CSR:
    """CSR of (A^T if trans else A), for ``a`` given as CSR or CSC.

    A CSC of A is byte-identical to a CSR of A^T, so (CSC, trans=True) is a
    zero-copy reinterpretation; the other derived forms run one cached host
    transpose (``formats.csr_transpose``).
    """
    if isinstance(a, CSR):
        if not trans:
            return a
        return _derived(a, "csr_T", lambda: csr_transpose(a))
    if isinstance(a, CSC):
        m, n = a.shape
        if trans:
            return _derived(a, "csr_T",
                            lambda: CSR((n, m), a.indptr, a.indices, a.data))
        return _derived(a, "csr", a.tocsr)
    raise TypeError(
        f"expected sblas_torch.CSR or sblas_torch.CSC, got "
        f"{type(a).__module__}.{type(a).__name__}; convert a matrix of "
        "another package with sblas_torch.from_reference(a)")


def relabeled(a: CSR):
    """:func:`~sblas_torch.relabel.hub_relabel` of ``a``, computed once per
    matrix: the SpMV and SpMM plans of one graph share it."""
    return _derived(a, "relabel", lambda: hub_relabel(a))


def _derived(src, key: str, build):
    cache = _DERIVED.setdefault(src, {})
    if key not in cache:
        cache[key] = build()
    return cache[key]
