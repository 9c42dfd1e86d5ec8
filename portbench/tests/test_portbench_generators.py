"""The configurations' generators: HPCG's stencil and GAP's kron graph."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.generators import hpcg, kron

HPCG = {"diagonal": 26.0, "off_diagonal": -1.0, "dtype": "float64"}
KRON = {"edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19, "graph_seed": 5}


def dense(g: dict) -> np.ndarray:
    n, m = g["shape"]
    indptr = g["indptr"].numpy().astype(np.int64)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    out = np.zeros((n, m))
    data = np.ones(rows.size) if g["data"] is None else g["data"].numpy()
    np.add.at(out, (rows, g["indices"].numpy()), data)
    return out


@pytest.mark.parametrize("nx,ny,nz", [(4, 4, 4), (5, 6, 7), (16, 16, 16)])
def test_hpcg_counts_and_values(nx, ny, nz):
    g = hpcg.generate({**HPCG, "nx": nx, "ny": ny, "nz": nz}, 0, "cpu")
    n = nx * ny * nz
    assert g["shape"] == (n, n)
    assert g["indices"].numel() == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    assert int(g["indptr"][-1]) == g["indices"].numel()
    assert g["indptr"].dtype == g["indices"].dtype == torch.int32
    a = dense(g)
    assert np.array_equal(a, a.T)
    assert np.all(np.diag(a) == 26.0)
    off = a - np.diag(np.diag(a))
    assert set(np.unique(off)) <= {0.0, -1.0}
    # an interior row holds all 27 points; a corner 8
    assert int(np.diff(g["indptr"].numpy()).max()) == 27
    assert int(np.diff(g["indptr"].numpy()).min()) == 8


def test_hpcg_columns_ascend():
    g = hpcg.generate({**HPCG, "nx": 6, "ny": 5, "nz": 4}, 0, "cpu")
    ptr, idx = g["indptr"].numpy(), g["indices"].numpy()
    for r in range(len(ptr) - 1):
        assert np.all(np.diff(idx[ptr[r]:ptr[r + 1]]) > 0)


@pytest.mark.parametrize("scale", [10, 11])
def test_kron_graph(scale):
    g = kron.generate({**KRON, "scale": scale}, 12345, "cpu")
    n = 1 << scale
    a = dense(g)
    assert g["shape"] == (n, n)
    assert np.array_equal(a, a.T)                  # undirected
    assert np.all(np.diag(a) == 0)                 # no self-loops
    assert a.max() == 1.0                          # no duplicates
    nnz = g["indices"].numel()
    # at most both directions of every drawn edge; duplicates removed
    assert nnz <= 2 * 16 * n and nnz % 2 == 0
    assert nnz > 0.6 * 2 * 16 * n
    deg = np.diff(g["indptr"].numpy())
    assert deg.max() > 8 * deg.mean()              # skewed


def test_kron_seeded():
    """The same seed, the same graph; another seed, the same graph under
    other labels."""
    cfg = {**KRON, "scale": 9}
    one, two = kron.generate(cfg, 7, "cpu"), kron.generate(cfg, 7, "cpu")
    other = kron.generate(cfg, 8, "cpu")
    assert torch.equal(one["indices"], two["indices"])
    assert torch.equal(one["indptr"], two["indptr"])
    assert not torch.equal(one["indptr"], other["indptr"])
    a, b = dense(one), dense(other)
    la, lb = one["labels"].numpy(), other["labels"].numpy()
    assert np.array_equal(a[np.ix_(la, la)], b[np.ix_(lb, lb)])


def _power_iteration_plain(inputs, sources, damping, tol, max_iters):
    """The reference's power iteration written plainly, a new tensor each
    step and the teleport as a dense term."""
    from portbench.reference.sparse import csr_f64, degrees, matmul

    a, n = csr_f64(inputs), inputs["shape"][0]
    deg = degrees(inputs)
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                      torch.zeros_like(deg))
    if sources is None:
        x = torch.full((n,), 1.0 / n, dtype=torch.float64)
        tele = torch.full_like(x, (1.0 - damping) / n)
    else:
        x = torch.zeros((n, sources.numel()), dtype=torch.float64)
        x[sources.long(), torch.arange(sources.numel())] = 1.0
        tele = x * (1.0 - damping)
    for it in range(1, max_iters + 1):
        x_new = tele + damping * matmul(
            a, x * (inv if x.dim() == 1 else inv[:, None]))
        err = (x_new - x).abs().sum(dim=0)
        x = x_new
        if float(err.max()) < tol:
            break
    return x, it


@pytest.mark.parametrize("sources", [None, [1, 7, 100, 900]])
def test_pagerank_reference_in_place_gives_the_plain_bits(sources):
    """The reference works in place to fit a batch at 2**25 vertices; it
    gives the plain loop's bits and iterations."""
    from portbench.reference import pagerank

    g = kron.generate({**KRON, "scale": 10}, 12345, "cpu")
    src = None if sources is None else torch.tensor(sources)
    want, n_want = _power_iteration_plain(g, src, 0.85, 1e-4, 20)
    got, n_got = pagerank.power_iteration(g, src, damping=0.85, tol=1e-4,
                                          max_iters=20)
    assert n_got == n_want and torch.equal(got, want)
