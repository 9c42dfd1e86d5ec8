"""``sblas-torch-bench``: the port's benchmark CLI, the counterpart of
``sblas/cli.py`` (``sblas-bench``).

One subcommand a routine, each printing one JSON record (and appending it to
``--json``), validated against scipy first:

    sblas-torch-bench spmv   --matrix cant --method auto --json out.jsonl
    sblas-torch-bench spmm   --matrix consph --k 32
    sblas-torch-bench sptrsv --matrix chol:poisson:120 --compare-reference
    sblas-torch-bench sptrsm --matrix chol:poisson:120 --k 8
    sblas-torch-bench solve  --matrix poisson:256 --dtype f64 --precond ichol
    sblas-torch-bench stream
    sblas-torch-bench --device cpu spmv --matrix poisson:64

(also ``python -m sblas_torch.cli``). Everything runs on the card unless
``--device cpu`` is given; without a card the default raises. The JAX
CLI's ``--x64`` and ``--platform`` have no counterpart: ``--dtype f64``
needs no switch, and ``--device`` picks the device. ``dist-spmv`` comes with
the port's distributed plans and is not offered yet. A record carries the
JAX CLI's keys (``name``, ``seconds_per_iter``, ``gflops``, ``gbps``,
``matrix``) and in ``extra`` the device, the route and its reason,
``rel_err``, and on the card the bound (``bound_us``) and cuSPARSE
(``baseline_us``). A failed check raises: the command exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .utils.backend import pick_device

# the JAX CLI's names of the block kernel at its two heights
SPMM_ALIASES = {"bsr_pallas_t": 128, "bsr_pallas": 64}
SOLVERS = ("cg", "bicgstab", "gmres")


def _load_matrix(spec: str, scale: float, dtype):
    """Resolve a matrix spec: a .mtx path, a SUITE name, a generator spec
    ('poisson:N', 'band:N:W', 'tri:N:D', 'chol:NAME'), or
    'random:M:D[:skew]' (``sblas/cli.py:_load_matrix``)."""
    from . import datasets

    if spec.startswith("poisson:"):
        return datasets.poisson2d(int(spec.split(":")[1]), dtype=dtype)
    if spec.startswith("band:"):
        _, n, w = spec.split(":")
        return datasets.banded(int(n), int(w), dtype=dtype)
    if spec.startswith("tri:"):
        parts = spec.split(":")
        n, d = int(parts[1]), float(parts[2])
        return datasets.lower_triangular(n, d, dtype=dtype)
    if spec.startswith("chol:"):
        # a benchmark labelled chol:X measures a real Cholesky factor of X
        base = spec.split(":", 1)[1]
        a = _load_matrix(base, scale, np.float64)
        return datasets.cholesky_factor(a, dtype=dtype)
    if spec.startswith("random:"):
        parts = spec.split(":")
        m, d = int(parts[1]), float(parts[2])
        skew = float(parts[3]) if len(parts) > 3 else 0.0
        return datasets.random_csr(m, m, d, skew=skew, dtype=dtype)
    return datasets.load(spec, scale=scale, dtype=dtype)


def _dtype(s: str):
    return {"f32": np.float32, "f64": np.float64,
            "float32": np.float32, "float64": np.float64}[s]


def _emit(rec, args) -> dict:
    d = rec.as_dict()
    line = json.dumps(d)
    print(line, flush=True)
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")
    return d


@contextlib.contextmanager
def _profile(path, dev: torch.device):
    """A ``torch.profiler`` trace of the block, written to
    ``<path>/trace.json`` (Chrome trace format); nothing without a path."""
    if not path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sblas-torch-bench",
        description="sparse BLAS benchmarks on one NVIDIA card "
                    "(the PyTorch/CUDA port of sblas-bench)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu (the "
                        "kernels' plain torch versions, host clock)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, tri=False):
        sp.add_argument("--matrix", default="tri:20000:8" if tri else "cant",
                        help=".mtx path | SUITE name | generator spec")
        sp.add_argument("--scale", type=float, default=1.0)
        sp.add_argument("--dtype", default="f32", type=str)
        sp.add_argument("--iters", type=int, default=None,
                        help="time between ITERS // 5 and ITERS iterations "
                             "(default: the bench's own, 5-25, solves 1-4)")
        sp.add_argument("--no-validate", action="store_true")
        sp.add_argument("--json", default=None, help="append JSON result here")
        sp.add_argument("--profile", default=None,
                        help="write a torch.profiler trace to this dir")

    sp = sub.add_parser("spmv")
    common(sp)
    sp.add_argument("--method", default="auto",
                    choices=["auto", "csr", "merge", "pseg", "pseg_big", "rcm",
                             "coo", "ell", "bucket", "bsr", "pallas",
                             "pallas_ds"])
    sp.add_argument("--value-dtype", default=None, choices=["bf16"],
                    help="store matrix values in bf16 on the kernel routes "
                         "(halves the value stream; ~1e-3 value rounding)")

    sp = sub.add_parser("spmm")
    common(sp)
    sp.add_argument("--k", type=int, default=8)
    sp.add_argument("--method", default="auto",
                    choices=["auto", "block", "merge", "pallas", "pseg",
                             "spmv_passes", "ell", "bucket", "bsr",
                             "pallas_ds", *SPMM_ALIASES])
    sp.add_argument("--value-dtype", default=None, choices=["bf16"])

    sp = sub.add_parser("sptrsv")
    common(sp, tri=True)
    sp.add_argument("--tile-rows", type=int, default=0,
                    help="tiles only: rows a tile")
    sp.add_argument("--method", default="auto",
                    choices=["auto", "syncfree", "tiles", "pallas",
                             "pallas_ds", "jacobi"])
    sp.add_argument("--sweeps", type=int, default=None,
                    help="jacobi only: sweep count (default exact = "
                         "nlevels-1); fewer = truncated preconditioner-"
                         "grade solve, rel_err reported")
    sp.add_argument("--compare-reference", action="store_true",
                    help="also time the plain level-set solve")

    sp = sub.add_parser("sptrsm")
    common(sp, tri=True)
    sp.add_argument("--k", type=int, default=8)

    sp = sub.add_parser("solve")
    common(sp)
    sp.add_argument("--solver", default="cg", choices=list(SOLVERS))
    sp.add_argument("--precond", default="none",
                    choices=["none", "jacobi", "ichol", "ilu"])
    sp.add_argument("--trsv-sweeps", type=int, default=None,
                    help="ichol/ilu: apply triangular solves as N jacobi "
                         "sweeps instead of exactly")
    sp.add_argument("--tol", type=float, default=1e-6)
    sp.add_argument("--maxiter", type=int, default=2000)

    sp = sub.add_parser("stream")
    sp.add_argument("--json", default=None)
    return p


def _solve(args, mat, dev):
    """One Krylov solve of ``A x = b`` (``b`` from seed 0), timed on the
    device's clock by :func:`~sblas_torch.bench_lib.bench_solver`."""
    from . import bench_lib, solvers
    from .utils.timing import BenchRecord

    b = np.random.default_rng(0).standard_normal(mat.shape[0]).astype(
        mat.dtype)
    sw = args.trsv_sweeps
    make = {"none": None,
            "jacobi": lambda: solvers.jacobi(mat, device=dev),
            "ichol": lambda: solvers.ichol(mat, trsv_sweeps=sw, device=dev),
            "ilu": lambda: solvers.ilu(mat, trsv_sweeps=sw,
                                       device=dev)}[args.precond]
    fn = getattr(solvers, args.solver)
    row = bench_lib.bench_solver(fn, mat, b, M=make() if make else None,
                                 device=dev, tol=args.tol,
                                 maxiter=args.maxiter)
    it = row["iterations"]
    if not args.no_validate and not (row["rel_residual"] <= args.tol
                                     and np.isfinite(row["true_rel_residual"])):
        raise RuntimeError(f"{args.solver}+{args.precond} did not converge to "
                           f"{args.tol} in {it} iterations: {row}")
    extra = {"iterations": it, "rel_residual": row["rel_residual"],
             "true_rel_err": row["true_rel_residual"],
             "rel_err": row["true_rel_residual"],
             "solve_seconds": row["wall_s"], "tol": args.tol,
             "solver": args.solver, "precond": args.precond,
             **{k: row[k] for k in ("method", "route_reason", "device",
                                    "dtype", "n", "nnz", "ms_per_iter",
                                    "ms_per_iter_split", "kernel_share",
                                    "timer") if k in row}}
    return BenchRecord(name=f"{args.solver}_{args.precond}",
                       seconds_per_iter=row["wall_s"] / max(it, 1),
                       flops=2.0 * mat.nnz * it, extra=extra)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    dev = pick_device(args.device)

    from . import bench_lib
    from .utils.timing import BenchRecord, stream_bandwidth

    if args.cmd == "stream":
        bw = stream_bandwidth(dev)
        extra = {"device": bench_lib.device_name(dev)}
        if dev.type == "cpu":
            extra["timer"] = "host"
        _emit(BenchRecord("stream_triad", 1.0, bytes=bw * 1e9, extra=extra),
              args)
        return 0

    mat = _load_matrix(args.matrix, args.scale, _dtype(args.dtype))
    kw = {"device": dev, "validate": not args.no_validate,
          "iters": args.iters}
    vd = torch.bfloat16 if getattr(args, "value_dtype", None) == "bf16" \
        else None
    with _profile(args.profile, dev):
        if args.cmd == "spmv":
            rec = bench_lib.bench_spmv(mat, method=args.method,
                                       value_dtype=vd, **kw)
        elif args.cmd == "spmm":
            method, br = args.method, 128
            if method in SPMM_ALIASES:
                method, br = "block", SPMM_ALIASES[method]
            rec = bench_lib.bench_spmm(mat, args.k, method=method,
                                       value_dtype=vd, block_rows=br, **kw)
            rec.extra["requested"] = args.method
        elif args.cmd == "sptrsv":
            rec = bench_lib.bench_sptrsv(
                mat, method=args.method, sweeps=args.sweeps,
                tile_rows=args.tile_rows,
                compare_reference=args.compare_reference, **kw)
        elif args.cmd == "sptrsm":
            rec = bench_lib.bench_sptrsm(mat, args.k, **kw)
        else:
            rec = _solve(args, mat, dev)
    rec.extra["matrix"] = args.matrix
    _emit(rec, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
