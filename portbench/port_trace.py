"""What the port records of its own work, as the metric readers take it:
``sblas_torch.trace``'s set-up spans (seconds of self time by phase) and
the sync-free solve's cycle sums. A port without that module gives None
for each, as a port that recorded nothing does."""

from __future__ import annotations

import importlib


def _trace():
    try:
        return importlib.import_module("sblas_torch.trace")
    except ModuleNotFoundError as e:
        # a port that has no such module records nothing; a module that
        # is there and fails to import raises
        if e.name != "sblas_torch.trace":
            raise
        return None


def phase_s(phase: str):
    """Seconds of the port's set-up spans in ``phase`` (their self time),
    or None where none was recorded."""
    trace = _trace()
    if trace is None:
        return None
    return trace.totals()["phases"].get(phase)


def solve_cycles() -> dict | None:
    """The counting solve's cycles by step (``load``, ``wait``, ``fence``,
    ``gather``, ``store``), or None where no counting launch ran."""
    trace = _trace()
    if trace is None:
        return None
    counts = trace.solve_counts()
    if not counts:
        return None
    return {s: counts[f"sptrsv_csr.{s}_cycles"] for s in trace.SOLVE_STEPS}
