"""Small sizes of the benchmark's configurations, for the CPU tests: the
port's plain versions run there (``device="cpu"``). A configuration of a
kind not in ``SMALL`` gives its own, under ``"small"`` in its file; a cell
of several chips runs as its ranks, on gloo (:mod:`portbench.launch`)."""

from __future__ import annotations

import pytest
import torch

from portbench import harness

SEED = 2**33 + 11          # past 32 bits, as a run's seed may be
SMALL = {"hpcg": {"nx": 10, "ny": 10, "nz": 10}, "kron": {"scale": 10}}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def small_config(bench: dict, cell: str) -> dict:
    cfg = harness.config_of(bench, harness.cell_of(bench, cell)["config"])
    return {**cfg, **(SMALL[cfg["kind"]] if cfg["kind"] in SMALL
                      else cfg["small"])}


def run_small(bench: dict, cell: str, *, trace: bool = False,
              control: bool = False, seconds: float = 0.3,
              seed: int = SEED, traffic: dict | None = None):
    """``(result, lines)`` of the cell at its small size on the CPU."""
    result, lines, _ = harness.run_cell(
        cell, seed, seconds, trace, device="cpu", bench=bench,
        config=small_config(bench, cell), traffic=traffic, control=control)
    return result, lines


@pytest.fixture
def card():
    """Skips the test where torch sees no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark runs on CUDA only")
    return torch.device("cuda")
