"""The check that decides ``correct`` has to fail: under the control (the
port's lower-precision path) and under each fault the cell can have,
planted underneath the timed path while the rest of a run goes on."""

from __future__ import annotations

import pytest
import torch

from sblas_torch.ops.spmm import SpmmPlan
from sblas_torch.ops.spmv import SpmvPlan

from .conftest import run_small

CELLS = ["hpcg-256.ic0-cg", "hpcg-256.jacobi-cg", "gap-kron25.pagerank",
         "gap-kron25.ppr-k32"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    res, lines = run_small(bench, cell, control=True)
    assert res["correct"] is False
    ((name, c),) = res["compared"].items()
    assert not c["value"] < c["limit"]
    assert lines[-1] == f"compared {name} {c['value']!r} limit " \
        f"{c['limit']!r}"


def _unchanged(self, x, alpha=1.0, beta=0.0, y=None):
    """A step that returns its state unchanged."""
    return torch.as_tensor(x, dtype=self.dtype, device=self.device)


def _patch(monkeypatch, fault):
    for cls in (SpmvPlan, SpmmPlan):
        monkeypatch.setattr(cls, "__call__", fault(cls.__call__))


def _altered(call):
    """The product's first entry altered where the kernel produces it."""
    def f(self, x, alpha=1.0, beta=0.0, y=None):
        out = call(self, x, alpha, beta, y)
        out.view(-1)[0] += 1e-3 * out.abs().max() + 1e-3
        return out
    return f


def _half_batch(call):
    """Half of the batch's columns left out of the product."""
    def f(self, x, alpha=1.0, beta=0.0, y=None):
        out = call(self, x, alpha, beta, y)
        if out.dim() == 2 and out.shape[1] > 1:
            out[:, out.shape[1] // 2:] = 0
        return out
    return f


FAULTS = {"unchanged": lambda call: _unchanged, "altered": _altered,
          "half_batch": _half_batch}
CASES = [(c, f) for c in CELLS for f in ("unchanged", "altered")] + \
    [("gap-kron25.ppr-k32", "half_batch")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(bench, monkeypatch, cell, fault):
    _patch(monkeypatch, FAULTS[fault])
    res, _ = run_small(bench, cell)
    assert res["correct"] is False


def test_answer_altered_after_the_solve(bench, monkeypatch):
    """An answer altered where the solver hands it back."""
    import sblas_torch.solvers as solvers

    cg = solvers.cg

    def bad(*a, **k):
        x, info = cg(*a, **k)
        x = x.clone()
        x[0] += 1.0
        return x, info

    monkeypatch.setattr(solvers, "cg", bad)
    res, _ = run_small(bench, "hpcg-256.ic0-cg")
    assert res["correct"] is False
