"""Input normalization shared by the port's op entry points.

Same contract as ``sblas/ops/common.py`` (re-implemented, because
``sblas.ops`` imports JAX): every entry point accepts ``CSR | CSC`` and a
``trans=`` flag, and :func:`as_csr` reduces the four combinations to a CSR
of the operator actually applied. Derived matrices are cached weakly per
source object, so repeated calls reuse both the host conversion and,
through the plan cache keyed on the derived CSR, its device tensors.
"""

from __future__ import annotations

import weakref

from sblas.formats import CSC, CSR, csr_transpose

# source matrix -> {"csr": CSR of A, "csr_T": CSR of A^T}
_DERIVED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def as_csr(a, trans: bool = False) -> CSR:
    """CSR of (A^T if trans else A), for ``a`` given as CSR or CSC.

    A CSC of A is byte-identical to a CSR of A^T, so (CSC, trans=True) is a
    zero-copy reinterpretation; the other derived forms run one cached host
    transpose (``sblas.formats.csr_transpose``).
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
    raise TypeError(f"expected sblas.CSR or sblas.CSC, got {type(a).__name__}")


def _derived(src, key: str, build) -> CSR:
    cache = _DERIVED.setdefault(src, {})
    if key not in cache:
        cache[key] = build()
    return cache[key]
