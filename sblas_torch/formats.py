"""Carry a host matrix onto a torch device.

The JAX package's "parameters" are a host :class:`sblas.CSR` of numpy
arrays; the port takes exactly the same object, so both packages compute on
identical data. :func:`to_device` uploads it as the plain CSR triple the
port's kernels read.
"""

from __future__ import annotations

import numpy as np
import torch

from sblas.formats import CSR, INDEX_DTYPE

VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name (``"bfloat16"``) or anything
    ``numpy.dtype`` takes (``np.float32``, ``jnp.bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype torch knows: {dtype!r}")
    return out


def to_device(a: CSR, device, value_dtype=None) -> dict:
    """Upload ``a`` to ``device``.

    Returns ``{"shape": (m, n), "indptr", "indices", "data"}``: ``indptr``
    and ``indices`` as int32 (``sblas.formats.INDEX_DTYPE``), ``data`` in
    ``value_dtype`` (default: the matrix's own), which must be f32, bf16 or
    f64. bf16 values are rounded from the host values to nearest even, as
    the JAX package does. Raises ``ValueError`` for nnz >= 2**31 (the int32
    offsets would overflow) and for complex values.
    """
    if not isinstance(a, CSR):
        raise TypeError(f"expected sblas.CSR, got {type(a).__name__}")
    if a.nnz >= 2**31:
        raise ValueError(f"nnz={a.nnz} >= 2**31 overflows the int32 offsets")
    if np.iscomplexobj(a.data):
        raise ValueError("complex values are not supported by the port's "
                         "kernels (f32, bf16 or f64 only)")
    vd = as_torch_dtype(a.dtype if value_dtype is None else value_dtype)
    if vd not in VALUE_DTYPES:
        raise ValueError(f"value dtype must be f32, bf16 or f64, got {vd}")
    device = torch.device(device)

    def up(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    return {
        "shape": tuple(a.shape),
        "indptr": up(a.indptr.astype(INDEX_DTYPE, copy=False)),
        "indices": up(a.indices.astype(INDEX_DTYPE, copy=False)),
        "data": up(a.data).to(vd),
    }
