"""What the solve loops share: the port's CSR from the generated arrays, the
sample of solves whose answers are kept, and the device's wait."""

from __future__ import annotations

import numpy as np
import torch


def host_csr(inputs: dict, data: torch.Tensor):
    """The port's host ``CSR`` of the generated pattern with ``data``: the
    port's plans take numpy matrices only, so the arrays go to the host."""
    from sblas_torch.formats import CSR

    return CSR(tuple(inputs["shape"]), inputs["indptr"].cpu().numpy(),
               inputs["indices"].cpu().numpy(), data.cpu().numpy())


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Sample:
    """Which solves' answers are kept for the check: ``size`` indices
    drawn from the seed among the ``expected`` solves of the window, and
    always the last solve."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng(int(seed))
        self.size = size
        self.chosen: set = set()

    def expect(self, expected: int) -> None:
        k = min(self.size, max(expected, 1))
        self.chosen = set(int(i) for i in self.rng.choice(
            max(expected, 1), size=k, replace=False))

    def keep(self, i: int) -> bool:
        return i in self.chosen


def work_generator(params: dict, device) -> torch.Generator:
    """The generator of the mix's fixed set of work (right-hand sides,
    source batches), from its ``work_seed``: every run solves the same set,
    in the order :func:`work_order` draws from the run's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(params["work_seed"]))
    return gen


def work_order(seed: int, size: int) -> list:
    """The order in which a run takes the ``size`` pieces of work, from the
    run's seed; solve ``i`` takes ``order[i % size]``."""
    return [int(i) for i in np.random.default_rng(int(seed)).permutation(size)]


def tri_lower_nnz(inputs: dict) -> int:
    """Stored entries on or below the diagonal."""
    indptr = inputs["indptr"].to(torch.int64)
    rows = torch.repeat_interleave(
        torch.arange(inputs["shape"][0], device=indptr.device),
        indptr[1:] - indptr[:-1])
    return int((inputs["indices"].to(torch.int64) <= rows).sum())
