"""The control of a cell's check: the port's own lower-precision path of
the traffic mix (its ``"control"``: the linear solves on the matrix in
float32 in place of float64, PageRank's operator values in bfloat16 in
place of float32), run through the whole cell at its own size, on each
seed, with a short window. Its numbers set the upper reading of each
limit, and it has to come out not correct. With ``--sound`` the same
seeds run the program as the cell states, for the lower reading.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        [--seconds 3] [--sound]

One line of JSON a seed: ``{"seed", "control", "correct", "compared"}``.
A cell of several chips runs as its ranks (:mod:`portbench.launch`).
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from . import harness

    chips = int(harness.cell_of(harness.load_benchmark(),
                                args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the control runs on {chips} CUDA device(s)", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in ([False, True] if args.sound else [True]):
            res, _, _ = harness.run_cell(args.workload, seed, args.seconds,
                                         False, control=control)
            print(json.dumps({"seed": seed, "control": control,
                              "correct": res["correct"],
                              "attempted": res["attempted"],
                              "compared": res["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
