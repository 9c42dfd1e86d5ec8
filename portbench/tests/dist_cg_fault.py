"""The tests' planted faults in the sharded CG loop
(:mod:`portbench.solves.dist_cg`), named by full path in a traffic mix
that only the tests make, on rank ``params["fault"]["rank"]``:
``scaled``, each answer of the window scaled by ``1 + 1e-3`` where the
loop keeps it; ``slow_warmup``, the rank's own count of the window's
solves, which comes from its warm-up's time, read as five more."""

from __future__ import annotations

from portbench.solves import dist_cg


class Solves(dist_cg.Solves):
    def __init__(self, inputs: dict, params: dict, seed: int, device,
                 spans, control: bool = False, rank: int = 0,
                 world: int = 1):
        super().__init__(inputs, params, seed, device, spans,
                         control=control, rank=rank, world=world)
        fault = params["fault"]
        self.fault = fault["kind"] if rank == int(fault["rank"]) else None

    def window(self, expected: int) -> None:
        super().window(expected + 5 if self.fault == "slow_warmup"
                       else expected)

    def solve(self, i: int) -> None:
        super().solve(i)
        if self.fault == "scaled" and i >= 0:
            self.last[2].mul_(1 + 1e-3)
