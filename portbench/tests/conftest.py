"""Small sizes of the benchmark's configurations, for the CPU tests: the
port's plain versions run there (``device="cpu"``)."""

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
    return {**cfg, **SMALL[cfg["kind"]]}


def run_small(bench: dict, cell: str, *, trace: bool = False,
              control: bool = False, seconds: float = 0.3,
              seed: int = SEED):
    return harness.run(cell, seed, seconds, trace, device="cpu",
                       bench=bench, config=small_config(bench, cell),
                       control=control)


@pytest.fixture
def card():
    """Skips the test where torch sees no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark runs on CUDA only")
    return torch.device("cuda")
