"""Dense-block (BSR) retiling: a sparse matrix as a list of dense
``br x bc`` blocks, the port's own copy, extended for its block kernel.

For matrices whose nonzeros cluster near the diagonal (the FEM suite), the
touched ``br x bc`` panels stored dense turn SpMM into a stream of small
dense products with no gather inside a block:

    Y[brow_b] += A_b @ X[bcol_b]      for every block b

The zeros stored inside each block are real memory traffic, so
``density`` (nnz over stored area) is reported beside the byte count.

Beside the JAX package's arrays (``blocks (nblocks, br, bc)``, ``brow``,
``bcol``, all sorted by block-row), :class:`BsrBlocks` carries ``bptr``: the
blocks of block-row ``i`` are ``bptr[i]:bptr[i+1]``, CSR over blocks, which
is how the kernel finds its blocks. The kernel reads each block transposed,
``(bc, br)`` (:meth:`BsrBlocks.blocks_t`), in the value dtype.

The JAX package caches large packings on disk, for a host build of a
block plan far larger than any the port's route rule builds; the port
packs in memory every time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .formats import CSR, INDEX_DTYPE


@dataclasses.dataclass(frozen=True, eq=False)
class BsrBlocks:
    m: int
    n: int
    nnz: int
    br: int  # block rows
    bc: int  # block cols
    nblocks: int
    blocks: np.ndarray   # (nblocks, br, bc) dense values
    brow: np.ndarray     # (nblocks,) block-row index, sorted
    bcol: np.ndarray     # (nblocks,) block-col index
    bptr: np.ndarray     # (num_brows + 1,) int32: CSR pointers over blocks
    num_brows: int
    num_bcols: int

    @property
    def density(self) -> float:
        return self.nnz / max(self.blocks.size, 1)

    def blocks_t(self) -> np.ndarray:
        """The blocks transposed, ``(nblocks, bc, br)``: for a fixed column
        ``j`` of a block, its ``br`` rows lie at consecutive addresses."""
        return np.ascontiguousarray(self.blocks.transpose(0, 2, 1))


def _block_ids(a: CSR, br: int, bc: int) -> np.ndarray:
    num_bcols = -(-max(a.shape[1], 1) // bc)
    rows = a.row_ids().astype(np.int64)
    cols = a.indices.astype(np.int64)
    return (rows // br) * num_bcols + (cols // bc)


def bsr_stats(a: CSR, *, br: int = 128, bc: int = 128) -> dict:
    """Block count, density and stored bytes (in the matrix's dtype),
    without allocating the blocks: a cheap probe for route selection."""
    nblocks = len(np.unique(_block_ids(a, br, bc)))
    area = max(nblocks, 1) * br * bc
    return {"nblocks": nblocks, "density": a.nnz / area,
            "bytes": area * a.data.itemsize}


def pack_bsr(a: CSR, *, br: int = 128, bc: int = 128) -> BsrBlocks:
    """Pack ``a`` into dense ``br x bc`` blocks sorted by (block-row,
    block-col). Rows and columns past ``m`` and ``n`` inside the last
    blocks hold zeros. A matrix with no nonzeros gives no blocks (the JAX
    package stores one zero block there)."""
    m, n = a.shape
    num_brows = -(-max(m, 1) // br)
    num_bcols = -(-max(n, 1) // bc)
    rows = a.row_ids().astype(np.int64)
    cols = a.indices.astype(np.int64)
    uniq, inv = np.unique(_block_ids(a, br, bc), return_inverse=True)
    nblocks = len(uniq)
    blocks = np.zeros((nblocks, br, bc), dtype=a.data.dtype)
    np.add.at(blocks, (inv, rows % br, cols % bc), a.data)
    brow = (uniq // num_bcols).astype(INDEX_DTYPE)
    bcol = (uniq % num_bcols).astype(INDEX_DTYPE)
    bptr = np.zeros(num_brows + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.bincount(brow, minlength=num_brows), out=bptr[1:])
    return BsrBlocks(m, n, a.nnz, br, bc, nblocks, blocks, brow, bcol, bptr,
                     num_brows, num_bcols)
