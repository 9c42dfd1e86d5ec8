#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sblas_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

It builds the port's CUDA kernels from the sources in the checkout and
holds each against its plain torch version on the card (the f64 builds of
the csr and solve kernels too). It drives the main paths a user calls,
each with every kernel launch count set to 0 just before it and read just
after:

- SpMV (``sblas_torch.spmv``, ``method="auto"``, f32 ``y = alpha A x +
  beta y``, bf16 values, ``trans``) on the emulated SuiteSparse ``cant`` at
  full size, a 1M-row FEM band matrix with 110M nonzeros, and the web
  graphs ``uk-2002`` at 5% and ``twitter7`` at 2% scale (BASELINE.json
  config 5); and ``method="rcm"`` on a band matrix with scrambled numbering;
- SpMM (``sblas_torch.spmm``, ``method="auto"``, ``Y = alpha A X + beta
  Y``) on full-size ``cant``, ``consph`` and ``pdb1HYS`` at K = 8 and 32,
  the FEM band at K = 8 and both graphs at K = 8 and 32;
- the triangular solves (``sblas_torch.sptrsv`` and ``sptrsm``,
  ``method="auto"``: the sync-free kernel) on the factors of BASELINE.json
  config 3 that ``benchmarks/run_suite.py`` solves (``band-parallel``,
  ``chol-nd-poisson2d-60`` and ``-120``) and on ``chol-nd-poisson2d-1000``,
  the same Cholesky factor at 1M rows and 50M nonzeros: K = 1 and 8, and
  ``trans=True`` (the Cholesky backsolve); and ``method="jacobi"`` on
  ``band-parallel``;
- f64 SpMV (BASELINE.json config 1: ``auto`` and ``method="pallas_ds"``,
  ``y = A x / 3 - y / 2``, ``trans``) on ``cant`` and the FEM band, f64
  SpMM (``auto``) on ``cant`` at K = 8, f64 SpMV and SpMM at K = 8
  (``auto``: the nnz-balanced kernel's f64 build) on ``uk-2002`` at 5%,
  and the f64 solves (``auto``: K = 1, 8 and the backsolve) on
  ``band-parallel`` and ``chol-nd-poisson2d-1000``, all on the f64 builds
  of the kernels;
- the Krylov solvers (``sblas_torch.solvers``): CG with Jacobi in f64 on a
  1M-row Poisson grid to convergence, IC(0)-CG, ILU(0)-BiCGSTAB and
  ILU(0)-GMRES(30) in f64 to convergence on 256 x 256 grids, and CG in f32
  on the 1M-row grid;

checks every result against scipy, and fails where the route the rule
picked launched no kernel (in f64: no f64 build). It times each kernel
beside its plain version, its bound (bytes at the card's data-sheet memory
rate, or flops at its rate for the type: fp32 or fp64), cuSPARSE and a
STREAM triad, times the routes of each matrix
against each other (``rule_picked``, ``faster_route``), times the SpMV
csr kernel at every lanes-per-row width it takes (each width checked
first), times each solve beside its plain version, its bound, its ns
per level and cuSPARSE's ``triangular_solve``, and times the solvers: ms
per iteration, split into the SpMV, the two triangular solves and the rest
(IC(0)-CG, ILU(0)-BiCGSTAB and ILU(0)-GMRES(30) for 30 iterations on the
1M-row grids), with the true residual. The solve kernel takes its tickets
level by level, small levels grouped; every factor's solve is also held
bit for bit to, and timed beside, the same kernel in plain level order and
in row order (its earlier ticket orders), the 1M-row IC(0)/ILU(0) factors
included. The nnz-balanced kernel is timed at
every share size it takes (``unit_sweep``). It imports only the port.

Output: one JSON line per phase; a ``{"kernels": [...]}`` line; the card's
``name, power.limit`` as nvidia-smi prints it; and last
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero; so it does without a CUDA device, where it prints no result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 1

    import sblas_torch
    from sblas_torch import datasets
    from sblas_torch import solvers
    from sblas_torch.bench_lib import (EPS, SOLVE_TOL, bench_solver,
                                       bench_spmm, bench_spmv, bench_sptrsm,
                                       bench_sptrsv)
    from sblas_torch.golden import (KERNEL_TOL, KERNEL_TOL_F64, rel_err,
                                    spmm_golden, spmv_golden, sptrsm_golden,
                                    sptrsv_golden, value_tol)
    from sblas_torch.ops.common import as_csr, relabeled
    from sblas_torch.ops.kernels import _build
    from sblas_torch.ops.kernels import spmm_bsr as bkern
    from sblas_torch.ops.kernels import spmm_csr as ckern
    from sblas_torch.ops.kernels import sptrsv_csr as skern
    from sblas_torch.ops.kernels import spmv_csr as kern
    from sblas_torch.ops.spmm import SpmmPlan
    from sblas_torch.ops.spmm import _get_plan as spmm_plan
    from sblas_torch.ops.spmv import (MERGE_SHARE_NS, _get_plan,
                                      csr_stream_bytes)
    from sblas_torch.ops.sptrsv import get_plan as sptrsv_plan
    from sblas_torch.retile_bsr import pack_bsr
    from sblas_torch.utils.backend import probe
    from sblas_torch.utils.timing import (HBM_BYTES_PER_S,
                                          measure_seconds_per_iter,
                                          peak_flops, stream_bandwidth)

    # the plain versions' products (torch.bmm) in full f32, stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    f32_tol = value_tol(torch.float32)
    # f64 SpMV and SpMM against scipy: the JAX package's ds class
    f64_tol = 1e-13
    t_start = time.perf_counter()
    # each kernel build's launch count: (wrapper module, counter)
    kernels = {"spmv_csr": (kern, "LAUNCHES"),
               "spmv_csr_f64": (kern, "LAUNCHES_F64"),
               "spmm_bsr": (bkern, "LAUNCHES"),
               "spmm_csr": (ckern, "LAUNCHES"),
               "spmm_csr_f64": (ckern, "LAUNCHES_F64"),
               "sptrsv_csr": (skern, "LAUNCHES"),
               "sptrsv_csr_f64": (skern, "LAUNCHES_F64")}

    def launched(kname):
        mod, attr = kernels[kname]
        return getattr(mod, attr)

    def vec(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def vec64(*shape):
        return rng.standard_normal(shape)

    def on_card(arr):
        return torch.from_numpy(arr).to(dev)

    # 1. probe ----------------------------------------------------------
    info = probe()
    emit({"phase": "probe", **info})
    if not info["nvidia_smi"]:
        raise RuntimeError("nvidia-smi gave no name, power.limit")
    card = info["nvidia_smi"].splitlines()[0]

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log = lib.with_suffix(".log")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib.name,
          "ptxas": _build.ptxas_report(log.read_text() if log.exists()
                                       else "")})

    # 3. the csr kernel vs its plain version on the card ----------------
    t0 = time.perf_counter()
    cant = datasets.emulate("cant", dtype=np.float32)
    consph = datasets.emulate("consph", dtype=np.float32)
    pdb = datasets.emulate("pdb1HYS", dtype=np.float32)
    fem_suite = {"cant": cant, "consph": consph, "pdb1HYS": pdb}
    suite_gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fem = datasets.random_csr(1_000_000, 1_000_000, 112, bandwidth=1500,
                              seed=7, dtype=np.float32)
    fem_gen_s = time.perf_counter() - t0
    # the web graphs of BASELINE.json config 5, at the scales
    # benchmarks/run_suite.py runs them
    graphs, graph_gen_s = {}, {}
    for name, scale in (("uk-2002@0.05", 0.05), ("twitter7@0.02", 0.02)):
        t0 = time.perf_counter()
        graphs[name] = datasets.emulate(name.split("@")[0], scale=scale,
                                        dtype=np.float32)
        graph_gen_s[name] = time.perf_counter() - t0
    # the triangular factors of BASELINE.json config 3, as
    # benchmarks/run_suite.py builds them, and the nested-dissection
    # Cholesky factor scaled up to 1M rows and 50M nonzeros. Both generators
    # compute in f64 and cast at the end, so the f32 factors are the f64
    # ones cast: the same bits as generating them in f32
    factors64, factor_gen_s = {}, {}
    t0 = time.perf_counter()
    factors64["band-parallel"] = datasets.lower_triangular(
        62451, 30, bandwidth=4000, seed=1, dtype=np.float64)
    factor_gen_s["band-parallel"] = time.perf_counter() - t0
    for grid in (60, 120, 1000):
        t0 = time.perf_counter()
        factors64[f"chol-nd-poisson2d-{grid}"] = datasets.cholesky_factor(
            datasets.poisson2d_nd(grid, dtype=np.float64), dtype=np.float64)
        factor_gen_s[f"chol-nd-poisson2d-{grid}"] = time.perf_counter() - t0
    factors = {name: l.astype(np.float32) for name, l in factors64.items()}
    # the f64 matrices of the f64 paths: the f32 ones cast (exact)
    cant64, fem64 = cant.astype(np.float64), fem.astype(np.float64)
    empty = sblas_torch.CSR((5, 7), np.zeros(6, np.int32),
                            np.zeros(0, np.int32), np.zeros(0, np.float32))
    cases = {
        "banded(300,5)": datasets.banded(300, 5),
        "random_csr(100,90,2)": datasets.random_csr(100, 90, 2, seed=4),
        "random_csr(400,400,12,skew=1.2)": datasets.random_csr(
            400, 400, 12, skew=1.2, seed=3),
        "nnz=0 (5x7)": empty,
        "cant": cant,
        "fem-band-1M-112M": fem,
    }
    max_abs = {name: 0.0 for name in kernels}

    def check_plain(kernel, label, got, want, tol=KERNEL_TOL):
        torch.cuda.synchronize()
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if g.shape != w.shape or not np.isfinite(g).all():
            raise RuntimeError(f"{label}: bad kernel output")
        err = rel_err(g, w)
        max_abs[kernel] = max(max_abs[kernel],
                              float(np.max(np.abs(g - w), initial=0.0)))
        if not err <= tol:
            raise RuntimeError(f"{label}: kernel vs plain rel_err {err} > "
                               f"{tol}")
        return err

    def against_plain(label, op, x, alpha, beta, yy):
        f64 = op["data"].dtype == torch.float64
        return check_plain("spmv_csr_f64" if f64 else "spmv_csr", label,
                           kern.spmv_csr(op, x, alpha, beta, yy),
                           kern.spmv_csr_reference(op, x, alpha, beta, yy),
                           KERNEL_TOL_F64 if f64 else KERNEL_TOL)

    for name, a in cases.items():
        x = on_card(vec(a.shape[1]))
        y = on_card(vec(a.shape[0]))
        errs = {}
        for vd in (torch.float32, torch.bfloat16):
            op = kern.prepare(sblas_torch.to_device(a, dev, vd))
            for alpha, beta, yy in ((2.5, -0.5, y), (1.0, 0.0, None)):
                label = f"{str(vd)[6:]},alpha={alpha}"
                errs[label] = against_plain(f"{name} {label}", op, x, alpha,
                                            beta, yy)
            del op
        # the f64 build: f64 values, x, y, alpha = 1/3 and beta
        a64 = {"cant": cant64, "fem-band-1M-112M": fem64}.get(name)
        op = kern.prepare(sblas_torch.to_device(
            a.astype(np.float64) if a64 is None else a64, dev))
        x64, y64 = on_card(vec64(a.shape[1])), on_card(vec64(a.shape[0]))
        for alpha, beta, yy in ((1 / 3, -0.5, y64), (1.0, 0.0, None)):
            label = f"float64,alpha={alpha:.4f}"
            errs[label] = against_plain(f"{name} {label}", op, x64, alpha,
                                        beta, yy)
        del op, x64, y64
        emit({"phase": "kernel_vs_plain", "kernel": "spmv_csr",
              "matrix": name, "nnz": a.nnz, "tol": KERNEL_TOL,
              "tol_f64": KERNEL_TOL_F64, "rel_err": errs})

    # 4. the block kernel vs its plain version on the card --------------
    def drop_rows(a, *spans):
        coo = a.tocoo()
        keep = np.ones(a.nnz, bool)
        for lo, hi in spans:
            keep &= (coo.row < lo) | (coo.row >= hi)
        return sblas_torch.COO(a.shape, coo.row[keep], coo.col[keep],
                               coo.data[keep]).tocsr()

    block_cases = {
        "banded(300,5)": datasets.banded(300, 5),
        "random_csr(300,200,6)": datasets.random_csr(300, 200, 6, seed=2),
        "empty block-rows (450x400)": drop_rows(
            datasets.random_csr(450, 400, 7, seed=6), (64, 320), (420, 450)),
        "nnz=0 (5x7)": empty,
        **fem_suite,
    }
    for name, a in block_cases.items():
        m, n = a.shape
        errs, pack_s = {}, {}
        for br in (128, 64):
            t0 = time.perf_counter()
            bsr = pack_bsr(a, br=br)
            pack_s[br] = time.perf_counter() - t0
            for vd in (torch.float32, torch.bfloat16):
                op = bkern.prepare(bkern.bsr_to_device(bsr, dev, vd))
                for k in (1, 3, 8, 32):
                    x, y = on_card(vec(n, k)), on_card(vec(m, k))
                    for alpha, beta, yy in ((2.5, -0.5, y), (1.0, 0.0, None)):
                        label = f"br={br},{str(vd)[6:]},K={k},Y={yy is not None}"
                        errs[label] = check_plain(
                            "spmm_bsr", f"{name} {label}",
                            bkern.spmm_bsr(op, x, alpha, beta, yy),
                            bkern.spmm_bsr_reference(op, x, alpha, beta, yy))
                del op
            del bsr
        emit({"phase": "spmm_kernel_vs_plain", "matrix": name, "nnz": a.nnz,
              "pack_bsr_s": pack_s, "tol": KERNEL_TOL,
              "max_rel_err": max(errs.values()), "cases": len(errs)})

    # 4b. the nnz-balanced kernel vs its plain version on the card ------
    long_rows = sblas_torch.COO(
        (400, 30000),
        np.concatenate([np.zeros(21000), np.full(24000, 9),
                        rng.integers(0, 300, 3000)]),
        np.concatenate([rng.permutation(30000)[:21000],
                        rng.permutation(30000)[:24000],
                        rng.integers(0, 30000, 3000)]),
        vec(48000)).tocsr()
    csr_cases = {
        "banded(300,5)": datasets.banded(300, 5),
        "random_csr(100,90,2)": datasets.random_csr(100, 90, 2, seed=4),
        "nnz=0 (5x7)": empty,
        "rows of 21000/24000 nnz, empty rows (400x30000)": long_rows,
    }
    t0 = time.perf_counter()
    for name, a in graphs.items():
        csr_cases[name] = a
        csr_cases[f"{name} hub-relabeled"] = relabeled(a)[0]
    relabel_s = time.perf_counter() - t0
    # the FEM matrices where the SpMM rule may pick the kernel: at the main
    # path's K = 8, f32 values (uniform rows, G = 8; ~107k shares on the band)
    csr_cases["cant"], csr_cases["fem-band-1M-112M"] = cant, fem
    depth = {"cant": ((torch.float32,), (8,)),
             "fem-band-1M-112M": ((torch.float32,), (8,))}
    for name, a in csr_cases.items():
        m, n = a.shape
        errs = {}
        vds, ks = depth.get(name, ((torch.float32, torch.bfloat16),
                                   (1, 3, 8, 32)))
        for vd in vds:
            op = ckern.prepare(sblas_torch.to_device(a, dev, vd))
            for k in ks:
                x, y = on_card(vec(n, k)), on_card(vec(m, k))
                for alpha, beta, yy in ((2.5, -0.5, y), (1.0, 0.0, None)):
                    label = f"{str(vd)[6:]},K={k},Y={yy is not None}"
                    errs[label] = check_plain(
                        "spmm_csr", f"{name} {label}",
                        ckern.spmm_csr(op, x, alpha, beta, yy),
                        ckern.spmm_csr_reference(op, x, alpha, beta, yy))
                del x, y
            shares, fixups = op["part"].shape[0] - 1, op["fix"].numel()
            del op
        emit({"phase": "spmm_csr_vs_plain", "matrix": name, "shape": a.shape,
              "nnz": a.nnz, "longest_row": int(a.row_lengths.max(initial=0)),
              "shares": shares, "fixups": fixups, "tol": KERNEL_TOL,
              "max_rel_err": max(errs.values()), "cases": len(errs)})

    # the nnz-balanced kernel's f64 build vs its plain version on both
    # graphs (the f64 values are the f32 ones cast), K = 1 and 8, alpha =
    # 1/3
    for name, a in graphs.items():
        m, n = a.shape
        errs = {}
        op = ckern.prepare(sblas_torch.to_device(a.astype(np.float64), dev))
        for k in (1, 8):
            x, y = on_card(vec64(n, k)), on_card(vec64(m, k))
            for alpha, beta, yy in ((1 / 3, -0.5, y), (1.0, 0.0, None)):
                label = f"float64,K={k},Y={yy is not None}"
                errs[label] = check_plain(
                    "spmm_csr_f64", f"{name} {label}",
                    ckern.spmm_csr(op, x, alpha, beta, yy),
                    ckern.spmm_csr_reference(op, x, alpha, beta, yy),
                    KERNEL_TOL_F64)
            del x, y
        del op
        emit({"phase": "spmm_csr_vs_plain", "matrix": name,
              "dtype": "float64", "nnz": a.nnz, "tol": KERNEL_TOL_F64,
              "max_rel_err": max(errs.values()), "cases": len(errs)})

    # 4c. the sync-free solve kernel vs its plain version on the card, on
    # each factor, lower (L) and upper (L^T, the backsolve), K = 1 and 8,
    # in f32 and (its f64 build) f64; and the same bits on 20 repeats ----
    for name, l in factors.items():
        errs, nlevels, t0 = {}, {}, time.perf_counter()
        for fl, kname, tol, mk in (
                (l, "sptrsv_csr", KERNEL_TOL, vec),
                (factors64[name], "sptrsv_csr_f64", KERNEL_TOL_F64, vec64)):
            for side, a, lower in (("L", fl, True),
                                   ("L^T", as_csr(fl, True), False)):
                op = sptrsv_plan(a, lower=lower)._op
                for k in (1, 8):
                    b = on_card(mk(a.shape[0], k))
                    got = skern.sptrsv_csr(op, b)
                    label = f"{side},K={k},{str(b.dtype)[6:]}"
                    errs[label] = check_plain(
                        kname, f"{name} {label}", got,
                        skern.sptrsv_csr_reference(op, b), tol)
                    # the tickets (levels, small ones grouped) against
                    # plain level order and the earlier row order: the
                    # same bits, and the same bits 20 times
                    level = {**op, "perm": on_card(skern.ticket_order(
                        op["levels"], lower, 0))}
                    for o in (skern.row_order(op), level):
                        if not torch.equal(skern.sptrsv_csr(o, b), got):
                            raise RuntimeError(f"{name} {label}: ticket "
                                               "order differs from row "
                                               "or level order")
                    for _ in range(20):
                        if not torch.equal(skern.sptrsv_csr(op, b), got):
                            raise RuntimeError(
                                f"{name} {label}: the solve changed "
                                "from run to run")
                nlevels[side] = op["nlevels"]
                del op, b, got
        emit({"phase": "sptrsv_kernel_vs_plain", "matrix": name,
              "n": l.shape[0], "nnz": l.nnz, "nlevels": nlevels,
              "longest_row": int(l.row_lengths.max(initial=0)),
              "tol": KERNEL_TOL, "tol_f64": KERNEL_TOL_F64, "rel_err": errs,
              "repeats_bit_equal": 20, "row_order_bit_equal": True,
              "level_order_bit_equal": True,
              "seconds": time.perf_counter() - t0})

    # 5. the main paths, through the user's entry points: the route is the
    # rule's pick, and each call must launch that route's kernel ---------
    by_route = {"csr": "spmv_csr", "rcm": "spmv_csr", "merge": "spmm_csr",
                "pseg": "spmm_csr", "block": "spmm_bsr",
                "syncfree": "sptrsv_csr"}

    def route_kernel(plan):
        """The counter of the kernel build ``plan``'s route launches."""
        route = plan._spmv.method if plan.method == "spmv_passes" \
            else plan.method
        kname = by_route[route]
        return kname + "_f64" if plan.dtype == torch.float64 else kname

    def check(res, name, label, call, plan_of, ref, tol):
        before = {k: launched(k) for k in kernels}
        out = call()
        torch.cuda.synchronize()
        plan = plan_of()
        kname = route_kernel(plan)
        if launched(kname) == before[kname]:
            raise RuntimeError(f"{name} {label}: route {plan.method!r} "
                               f"({plan.route_reason}) launched no {kname}")
        got = out.cpu().numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: bad output")
        err = rel_err(got, ref)
        if not err < tol:
            raise RuntimeError(f"{name} {label}: rel_err vs scipy {err} "
                               f">= {tol}")
        res[label] = {"rel_err": err, "tol": tol, "method": plan.method,
                      "kernel": kname, "route_reason": plan.route_reason}

    def spmv_main_path(name, a):
        m, n = a.shape
        x, y0, xt = vec(n), vec(m), vec(m)
        at = as_csr(a, True)    # the host transpose spmv builds and caches
        bf16 = {"value_dtype": torch.bfloat16}
        res = {}
        ref = spmv_golden(a, x)     # one golden per input
        check(res, name, "f32", lambda: sblas_torch.spmv(a, x),
              lambda: _get_plan(a, "auto"), ref, f32_tol)
        check(res, name, "f32 alpha/beta",
              lambda: sblas_torch.spmv(a, x, 2.5, -0.5, y0, method="auto"),
              lambda: _get_plan(a, "auto"),
              spmv_golden(a, x, 2.5, -0.5, y0), f32_tol)
        check(res, name, "bf16 values",
              lambda: sblas_torch.spmv(a, x, method="auto", **bf16),
              lambda: _get_plan(a, "auto", **bf16), ref,
              value_tol(torch.bfloat16))
        check(res, name, "f32 trans",
              lambda: sblas_torch.spmv(a, xt, trans=True, method="auto"),
              lambda: _get_plan(at, "auto"), spmv_golden(at, xt), f32_tol)
        return res

    def spmm_main_path(name, a, k, extra_checks, method="auto"):
        m, n = a.shape
        x, y0 = vec(n, k), vec(m, k)
        kw = {"method": method, "k_hint": k}
        bf16 = {**kw, "value_dtype": torch.bfloat16}
        res = {}
        ref = spmm_golden(a, x, 2.5, -0.5, y0)     # one golden per input
        t0 = time.perf_counter()
        check(res, name, "f32 alpha/beta",
              lambda: sblas_torch.spmm(a, x, 2.5, -0.5, y0, **kw),
              lambda: spmm_plan(a, method, k_hint=k), ref, f32_tol)
        first_s = time.perf_counter() - t0
        if "bf16" in extra_checks:
            check(res, name, "bf16 values alpha/beta",
                  lambda: sblas_torch.spmm(a, x, 2.5, -0.5, y0, **bf16),
                  lambda: spmm_plan(a, method, k_hint=k,
                                    value_dtype=torch.bfloat16),
                  ref, value_tol(torch.bfloat16))
        if "trans" in extra_checks:
            xt = vec(m, k)
            at = as_csr(a, True)
            check(res, name, "f32 trans",
                  lambda: sblas_torch.spmm(a, xt, trans=True, **kw),
                  lambda: spmm_plan(at, method, k_hint=k),
                  spmm_golden(at, xt), f32_tol)
        emit({"phase": "main_path", "path": "spmm", "matrix": name, "k": k,
              "method": method, "nnz": a.nnz, "first_call_s": first_s,
              "checks": res})

    def reset():
        for mod, attr in kernels.values():
            setattr(mod, attr, 0)

    def counts():
        torch.cuda.synchronize()
        return {name: launched(name) for name in kernels}

    # a band matrix with scrambled numbering: what rcm is for
    base = datasets.random_csr(100_000, 100_000, 40, bandwidth=60, seed=21,
                               dtype=np.float32)
    perm = np.random.default_rng(22).permutation(100_000)
    scrambled = sblas_torch.CSR.from_scipy(
        base.to_scipy().tocsr()[perm][:, perm])
    spmv_mats = {"cant": cant, "fem-band-1M-112M": fem, **graphs}

    reset()
    for name, a in spmv_mats.items():
        t0 = time.perf_counter()
        res = spmv_main_path(name, a)
        emit({"phase": "main_path", "path": "spmv", "matrix": name,
              "shape": a.shape, "nnz": a.nnz,
              "longest_row": int(a.row_lengths.max(initial=0)),
              "seconds": time.perf_counter() - t0, "checks": res})
    res = {}
    xs = vec(100_000)
    check(res, "scrambled band", "rcm f32",
          lambda: sblas_torch.spmv(scrambled, xs, method="rcm"),
          lambda: _get_plan(scrambled, "rcm"), spmv_golden(scrambled, xs),
          f32_tol)
    emit({"phase": "main_path", "path": "spmv",
          "matrix": "random_csr(100000,100000,40,bandwidth=60) scrambled",
          "nnz": scrambled.nnz, "checks": res})
    spmv_launches = counts()
    emit({"phase": "launches", "path": "spmv", **spmv_launches})
    for kname in ("spmv_csr", "spmm_csr"):
        if spmv_launches[kname] == 0:
            raise RuntimeError(f"the SpMV main path never launched {kname}")

    reset()
    for name, a in fem_suite.items():
        for k in (8, 32):
            spmm_main_path(name, a, k, {"bf16"} | (
                {"trans"} if name == "cant" else set()))
    spmm_main_path("fem-band-1M-112M", fem, 8, set())
    for name, a in graphs.items():
        for k in (8, 32):
            spmm_main_path(name, a, k, {"bf16"})
    spmm_launches = counts()
    emit({"phase": "launches", "path": "spmm", **spmm_launches})
    for kname in ("spmm_bsr", "spmm_csr"):
        if spmm_launches[kname] == 0:
            raise RuntimeError(f"the SpMM main path never launched {kname}")
    launches = {name: spmv_launches[name] + spmm_launches[name]
                for name in kernels}
    # the dense-block route by name, whichever route the rule picked above
    # (outside the main path's launch window)
    for name, a in fem_suite.items():
        spmm_main_path(name, a, 8, set(), method="block")

    # 5c. the triangular solves: sptrsv and sptrsm (auto: the sync-free
    # kernel), the Cholesky backsolve (trans), and the Jacobi sweeps. One
    # right-hand side per factor, made in f64, and one scipy golden of the
    # f64 factor per input: the f32 path solves the same b cast to f32 ----
    def check_solve(res, name, label, call, plan, ref, kname, tol):
        before = launched(kname)
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if launched(kname) == before:
            raise RuntimeError(f"{name} {label}: route {plan.method!r} "
                               f"({plan.route_reason}) launched no {kname}")
        got = out.cpu().numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: bad output")
        err = rel_err(got, ref)
        if not err < tol:
            raise RuntimeError(f"{name} {label}: rel_err vs scipy {err} "
                               f">= {tol}")
        res[label] = {"rel_err": err, "tol": tol, "method": plan.method,
                      "kernel": kname,
                      "route_reason": getattr(plan, "route_reason", None),
                      "nlevels": plan.nlevels, "seconds": seconds}

    goldens = {}
    t0 = time.perf_counter()
    for name, l in factors64.items():
        n = l.shape[0]
        b, bm = vec64(n), vec64(n, 8)
        goldens[name] = {
            "b": b, "bm": bm, "K=1": sptrsv_golden(l, b),
            "K=8": sptrsm_golden(l, bm),
            "trans K=1": sptrsv_golden(as_csr(l, True), b, lower=False)}
    solve_golden_s = time.perf_counter() - t0

    def solve_main_path(name, l, dtype):
        g = goldens[name]
        b, bm = g["b"].astype(dtype), g["bm"].astype(dtype)
        lt = as_csr(l, True)
        tol = SOLVE_TOL[np.dtype(dtype)]
        kname = "sptrsv_csr_f64" if dtype == np.float64 else "sptrsv_csr"
        res, t0 = {}, time.perf_counter()
        check_solve(res, name, "K=1", lambda: sblas_torch.sptrsv(l, b),
                    sptrsv_plan(l), g["K=1"], kname, tol)
        check_solve(res, name, "K=8", lambda: sblas_torch.sptrsm(l, bm),
                    sptrsv_plan(l), g["K=8"], kname, tol)
        check_solve(res, name, "trans K=1",
                    lambda: sblas_torch.sptrsv(l, b, trans=True),
                    sptrsv_plan(lt, lower=False), g["trans K=1"], kname, tol)
        emit({"phase": "main_path", "path": "sptrsv", "matrix": name,
              "dtype": np.dtype(dtype).name, "n": l.shape[0], "nnz": l.nnz,
              "seconds": time.perf_counter() - t0, "checks": res})

    reset()
    for name, l in factors.items():
        solve_main_path(name, l, np.float32)
    bp = factors["band-parallel"]
    b = goldens["band-parallel"]["b"].astype(np.float32)
    res = {}
    check_solve(res, "band-parallel", "jacobi K=1",
                lambda: sblas_torch.sptrsv(bp, b, method="jacobi"),
                sptrsv_plan(bp, method="jacobi"),
                goldens["band-parallel"]["K=1"],
                by_route[sptrsv_plan(bp, method="jacobi")._e.method],
                SOLVE_TOL[np.dtype(np.float32)])
    emit({"phase": "main_path", "path": "sptrsv", "matrix": "band-parallel",
          "checks": res,
          "sweeps": sptrsv_plan(bp, method="jacobi").sweeps})
    sptrsv_launches = counts()
    emit({"phase": "launches", "path": "sptrsv", **sptrsv_launches})
    if sptrsv_launches["sptrsv_csr"] == 0:
        raise RuntimeError("the solves' main path never launched sptrsv_csr")
    launches = {name: launches[name] + sptrsv_launches[name]
                for name in kernels}

    # 5d. f64 (BASELINE.json config 1): SpMV through auto and pallas_ds by
    # name, y = A x / 3 - y / 2 and trans, on cant and the FEM band; SpMM
    # (auto) on cant at K = 8; SpMV and SpMM K = 8 (auto: the nnz-balanced
    # kernel's f64 build) on uk-2002@0.05 in f64; the solves (auto) on
    # band-parallel and chol-nd-poisson2d-1000. Each call must launch the
    # f64 build of its route's kernel ------------------------------------
    def spmv64_main_path(name, a):
        m, n = a.shape
        x, y0, xt = vec64(n), vec64(m), vec64(m)
        at = as_csr(a, True)
        ref = spmv_golden(a, x, 1 / 3, -0.5, y0)     # one golden per input
        res, t0 = {}, time.perf_counter()
        check(res, name, "f64 alpha=1/3, beta=-1/2",
              lambda: sblas_torch.spmv(a, x, 1 / 3, -0.5, y0),
              lambda: _get_plan(a, "auto"), ref, f64_tol)
        check(res, name, "pallas_ds alpha=1/3, beta=-1/2",
              lambda: sblas_torch.spmv(a, x, 1 / 3, -0.5, y0,
                                       method="pallas_ds"),
              lambda: _get_plan(a, "pallas_ds"), ref, f64_tol)
        check(res, name, "f64 trans",
              lambda: sblas_torch.spmv(a, xt, trans=True),
              lambda: _get_plan(at, "auto"), spmv_golden(at, xt), f64_tol)
        emit({"phase": "main_path", "path": "spmv", "matrix": name,
              "dtype": "float64", "nnz": a.nnz,
              "seconds": time.perf_counter() - t0, "checks": res})

    reset()
    for name, a in (("cant", cant64), ("fem-band-1M-112M", fem64)):
        spmv64_main_path(name, a)
    # the graph in f64: its values are the f32 ones cast
    uk64 = graphs["uk-2002@0.05"].astype(np.float64)
    for name, a in (("cant", cant64), ("uk-2002@0.05", uk64)):
        x, y0 = vec64(a.shape[1], 8), vec64(a.shape[0], 8)
        res = {}
        if a is uk64:
            xv, yv = x[:, 0].copy(), y0[:, 0].copy()
            check(res, name, "f64 SpMV alpha=1/3, beta=-1/2",
                  lambda: sblas_torch.spmv(a, xv, 1 / 3, -0.5, yv),
                  lambda: _get_plan(a, "auto"),
                  spmv_golden(a, xv, 1 / 3, -0.5, yv), f64_tol)
        check(res, name, "f64 K=8 alpha=1/3, beta=-1/2",
              lambda: sblas_torch.spmm(a, x, 1 / 3, -0.5, y0, k_hint=8),
              lambda: spmm_plan(a, "auto", k_hint=8),
              spmm_golden(a, x, 1 / 3, -0.5, y0), f64_tol)
        emit({"phase": "main_path", "path": "spmm", "matrix": name,
              "dtype": "float64", "k": 8, "checks": res})
    for name in ("band-parallel", "chol-nd-poisson2d-1000"):
        solve_main_path(name, factors64[name], np.float64)
    f64_launches = counts()
    emit({"phase": "launches", "path": "f64", **f64_launches})
    for kname in ("spmv_csr_f64", "spmm_csr_f64", "sptrsv_csr_f64"):
        if f64_launches[kname] == 0:
            raise RuntimeError(f"the f64 main path never launched {kname}")
    launches = {name: launches[name] + f64_launches[name]
                for name in kernels}

    # 5e. the solvers, through sblas_torch.solvers: CG + Jacobi in f64 on
    # the 1M-row Poisson grid to convergence; IC(0)-CG, ILU(0)-BiCGSTAB
    # and ILU(0)-GMRES(30) in f64 to convergence on 256 x 256 grids; CG in
    # f32 on the 1M-row grid. Each checked by its true residual (scipy,
    # f64) -----------------------------------------------------------------
    t0 = time.perf_counter()
    grid = {np.float64: datasets.poisson2d(1000, dtype=np.float64)}
    grid[np.float32] = grid[np.float64].astype(np.float32)
    small = {"poisson2d(256)": datasets.poisson2d(256, dtype=np.float64),
             "convection_diffusion(256)": datasets.convection_diffusion(
                 256, dtype=np.float64)}
    solver_gen_s = time.perf_counter() - t0

    def check_solver(res, label, solve, a, b, tol, limit, **kw):
        t0 = time.perf_counter()
        x, info = solve(a, b, tol=tol, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        xs = x.cpu().numpy().astype(np.float64)
        b64 = np.asarray(b, dtype=np.float64)
        true = float(np.linalg.norm(b64 - a.to_scipy().astype(np.float64)
                                    @ xs) / np.linalg.norm(b64))
        if xs.shape != b64.shape or not np.isfinite(xs).all():
            raise RuntimeError(f"{label}: bad solution")
        if not (info["rel_residual"] < tol and true <= limit):
            raise RuntimeError(f"{label}: {info}, true residual {true} > "
                               f"{limit}")
        res[label] = {**info, "true_rel_residual": true, "tol": tol,
                      "limit": limit, "seconds": seconds,
                      "ms_per_iter": 1e3 * seconds
                      / max(info["iterations"], 1)}

    reset()
    res = {}
    b1m = vec64(grid[np.float64].shape[0])
    check_solver(res, "cg+jacobi f64 poisson2d(1000)", solvers.cg,
                 grid[np.float64], b1m, 1e-8, 2e-8, maxiter=20000,
                 M=solvers.jacobi(grid[np.float64]))
    b256 = vec64(small["poisson2d(256)"].shape[0])
    p256, c256 = small["poisson2d(256)"], small["convection_diffusion(256)"]
    m_ic, m_ilu = solvers.ichol(p256), solvers.ilu(c256)
    check_solver(res, "ic0-cg f64 poisson2d(256)", solvers.cg, p256, b256,
                 1e-8, 2e-8, maxiter=5000, M=m_ic)
    check_solver(res, "ilu0-bicgstab f64 convection_diffusion(256)",
                 solvers.bicgstab, c256, b256, 1e-8, 2e-8, maxiter=5000,
                 M=m_ilu)
    check_solver(res, "ilu0-gmres(30) f64 convection_diffusion(256)",
                 solvers.gmres, c256, b256, 1e-8, 2e-8, maxiter=5000,
                 restart=30, M=m_ilu)
    check_solver(res, "cg f32 poisson2d(1000)", solvers.cg,
                 grid[np.float32], b1m.astype(np.float32), 1e-4, 1e-3,
                 maxiter=20000)
    emit({"phase": "main_path", "path": "solvers", "checks": res,
          "levels": {"ic0 poisson2d(256)": [m_ic.fwd.nlevels,
                                            m_ic.bwd.nlevels],
                     "ilu0 convection_diffusion(256)": [
                         m_ilu.fwd.nlevels, m_ilu.bwd.nlevels]},
          "generate_s": solver_gen_s})
    solver_launches = counts()
    emit({"phase": "launches", "path": "solvers", **solver_launches})
    for kname in ("spmv_csr", "spmv_csr_f64", "sptrsv_csr_f64"):
        if solver_launches[kname] == 0:
            raise RuntimeError(f"the solvers' main path never launched "
                               f"{kname}")
    launches = {name: launches[name] + solver_launches[name]
                for name in kernels}
    del m_ic, m_ilu

    # the csr SpMV route by name on the graphs' rows of 10^5+ nonzeros, with
    # this run's random x (outside the launch windows)
    for name, a in graphs.items():
        x = vec(a.shape[1])
        err = rel_err(sblas_torch.spmv(a, x, method="csr").cpu().numpy(),
                      spmv_golden(a, x))
        emit({"phase": "csr_long_rows", "matrix": name,
              "longest_row": int(a.row_lengths.max(initial=0)),
              "rel_err": err, "tol": f32_tol})
        if not err < f32_tol:
            raise RuntimeError(f"{name}: csr route rel_err {err} >= "
                               f"{f32_tol}")

    # 6. SpMV timing: the csr kernel, the nnz-balanced one, their plain
    # versions, cuSPARSE and the bound ------------------------------------
    def bound_us(nbytes, flops, dtype=np.float32):
        bytes_s = nbytes / HBM_BYTES_PER_S
        flops_s = flops / peak_flops(dtype)
        return max(bytes_s, flops_s) * 1e6, \
            "bytes" if bytes_s >= flops_s else "operations"

    def us(step, x0, **kw):
        return 1e6 * measure_seconds_per_iter(step, x0, x0, **kw)

    # the plain versions take tens of ms on the graphs: fewer iterations
    few = {"iters_lo": 2, "iters_hi": 6, "repeats": 1}

    def x_gather_fit(a, k, merge_us):
        """The share of the X bytes the merge route gathers (K floats a
        nonzero) that its time pays at the STREAM rate beyond its CSR
        stream, X in and Y in and out: the SpMM rule's X_GATHER."""
        m, n = a.shape
        rest = csr_stream_bytes(m, a.nnz, 4) + (n + 2 * m) * k * 4
        return (merge_us * 1e-6 * stream_bandwidth(dev) * 1e9 - rest) / \
            (a.nnz * k * 4)

    timings = {}
    for name, a in (("cant", cant), ("fem-band-1M-112M", fem)):
        rec = bench_spmv(a, method="csr", ratio_pairs=3, device=dev)
        rec16 = bench_spmv(a, method="csr", value_dtype=torch.bfloat16,
                           device=dev, baseline=False)
        merge = bench_spmv(a, method="merge", device=dev, baseline=False)
        t = sblas_torch.to_device(a, dev)
        x0 = on_card(vec(a.shape[1]))
        plain = us(lambda x, x0: kern.spmv_csr_reference(t, x, EPS, 1.0, x0),
                   x0)
        # what an eager caller of the entry point waits per call, host
        # Python included (the graph-timed numbers above leave it out)
        sblas_torch.spmv(a, x0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            sblas_torch.spmv(a, x0)
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) / 200
        bound = max(rec.bytes / HBM_BYTES_PER_S,
                    rec.flops / peak_flops(a.dtype))
        kernel_us, merge_us = rec.seconds_per_iter * 1e6, \
            merge.seconds_per_iter * 1e6
        timings[name] = {"kernel_us": kernel_us, "plain_us": plain,
                         "bound_us": bound * 1e6,
                         "cusparse_us": rec.extra["baseline_us"]}
        emit({"phase": "timing", "kernel": "spmv_csr", "matrix": name,
              "card": card,
              "kernel_us": kernel_us, "kernel_gbps": rec.gbps,
              "pct_stream": rec.extra["pct_stream"],
              "stream_gbps": rec.extra["stream_gbps"],
              "bytes_per_iter": rec.bytes, "bound_us": bound * 1e6,
              "plain_us": plain,
              "eager_spmv_us_per_call": eager * 1e6,
              "cusparse_us": rec.extra["baseline_us"],
              "kernel_bf16_us": rec16.seconds_per_iter * 1e6,
              "kernel_bf16_gbps": rec16.gbps,
              "merge_us": merge_us,
              "rule_picked": _get_plan(a, "auto").method,
              "faster_route": "csr" if kernel_us <= merge_us else "merge",
              "rel_err": rec.extra["rel_err"],
              "ratio_pairs": rec.extra["ratio_pairs"]})
        del t, x0

    # 6a. f64: the csr kernel's f64 build (auto's route) on cant and the FEM
    # band, its plain version, cuSPARSE's f64 addmv and the bound (12 B a
    # nonzero, 8 B vectors, fp64 rate); uk-2002@0.05 in f64: the
    # nnz-balanced kernel's f64 build (auto's merge), its plain version,
    # cuSPARSE and the bound, against the csr kernel and the torch bucket
    # route, and SpMM at K = 8 (merge, spmv_passes, bucket); SpMM on cant
    # at K = 8 (auto) against the torch bsr route and cuSPARSE's addmm ---
    for name, a in (("cant", cant64), ("fem-band-1M-112M", fem64)):
        rec = bench_spmv(a, method="csr", ratio_pairs=3, device=dev)
        t = sblas_torch.to_device(a, dev)
        x0 = on_card(vec64(a.shape[1]))
        plain = us(lambda x, x0: kern.spmv_csr_reference(t, x, EPS, 1.0, x0),
                   x0)
        bound, by = bound_us(rec.bytes, rec.flops, np.float64)
        timings[name + " f64"] = {
            "kernel_us": rec.seconds_per_iter * 1e6, "plain_us": plain,
            "bound_us": bound, "bound_by": by,
            "cusparse_us": rec.extra["baseline_us"]}
        emit({"phase": "timing", "kernel": "spmv_csr_f64", "matrix": name,
              "card": card, **timings[name + " f64"],
              "kernel_gbps": rec.gbps, "pct_stream": rec.extra["pct_stream"],
              "stream_gbps": rec.extra["stream_gbps"],
              "bytes_per_iter": rec.bytes,
              "rule_picked": _get_plan(a, "auto").method,
              "route_reason": _get_plan(a, "auto").route_reason,
              "rel_err": rec.extra["rel_err"],
              "ratio_pairs": rec.extra["ratio_pairs"]})
        del t, x0
    routes = {r: bench_spmv(uk64, method=r, device=dev,
                            baseline=r == "merge")
              for r in ("merge", "csr", "bucket")}
    route_times = {r: rec.seconds_per_iter * 1e6 for r, rec in routes.items()}
    t = ckern.prepare(sblas_torch.to_device(uk64, dev))
    x0 = on_card(vec64(uk64.shape[1], 1))
    bound, by = bound_us(routes["merge"].bytes, routes["merge"].flops,
                         np.float64)
    timings["uk-2002@0.05 f64"] = {
        "kernel_us": route_times["merge"], "bound_us": bound,
        "bound_by": by, "cusparse_us": routes["merge"].extra["baseline_us"],
        "plain_us": us(lambda x, x0: ckern.spmm_csr_reference(
            t, x, EPS, 1.0, x0), x0, **few)}
    emit({"phase": "timing", "kernel": "spmm_csr_f64", "matrix":
          "uk-2002@0.05", "card": card, **timings["uk-2002@0.05 f64"],
          "route_us": route_times,
          "rule_picked": _get_plan(uk64, "auto").method,
          "route_reason": _get_plan(uk64, "auto").route_reason,
          "faster_route": min(route_times, key=route_times.get),
          "rel_err": {r: rec.extra["rel_err"] for r, rec in routes.items()}})
    del t, x0, routes
    routes = {r: bench_spmm(uk64, 8, method=r, device=dev,
                            baseline=r == "merge")
              for r in ("merge", "spmv_passes", "bucket")}
    route_times = {r: rec.seconds_per_iter * 1e6 for r, rec in routes.items()}
    emit({"phase": "spmm_timing", "matrix": "uk-2002@0.05",
          "dtype": "float64", "k": 8, "card": card, "route_us": route_times,
          "bound_us": routes["merge"].extra["bound_us"],
          "cusparse_us": routes["merge"].extra["baseline_us"],
          "rule_picked": spmm_plan(uk64, "auto", k_hint=8).method,
          "faster_route": min(route_times, key=route_times.get),
          "rel_err": {r: rec.extra["rel_err"] for r, rec in routes.items()}})
    del uk64, routes
    rec = bench_spmm(cant64, 8, method="auto", device=dev)
    others = {r: bench_spmm(cant64, 8, method=r, device=dev,
                            baseline=False).seconds_per_iter * 1e6
              for r in ("bsr", "merge", "spmv_passes")}
    emit({"phase": "spmm_timing", "matrix": "cant", "dtype": "float64",
          "k": 8, "card": card, "method": rec.extra["method"],
          "route_reason": rec.extra["route_reason"],
          "kernel_us": rec.seconds_per_iter * 1e6,
          "bound_us": rec.extra["bound_us"], "bound_by": rec.extra["bound_by"],
          "cusparse_us": rec.extra["baseline_us"], "route_us": others,
          "faster_route": min(others, key=others.get),
          "kernel_gbps": rec.gbps, "pct_stream": rec.extra["pct_stream"],
          "rel_err": rec.extra["rel_err"]})
    del rec

    # 6b. the graphs: the nnz-balanced kernel in natural order (the merge
    # route auto runs) and hub-relabeled (the pseg operand), its plain
    # version, cuSPARSE, the bound and every route, at K = 1, 8, 32 -------
    def route_us(a, k, routes):
        """Graph-timed us of each SpMM route through its plan, each first
        checked against one scipy golden of the same X."""
        x_np = vec(a.shape[1], k)
        want = spmm_golden(a, x_np)
        x0 = on_card(x_np)
        out = {}
        for r in routes:
            plan = spmm_plan(a, r, k_hint=k)
            err = rel_err(plan(x0).cpu().numpy(), want)
            if not err < f32_tol:
                raise RuntimeError(f"{r} on K={k}: rel_err {err}")
            out[r] = us(lambda x, x0, plan=plan: plan(x, EPS, 1.0, x0), x0)
        return out

    graph_timings = {}
    for name, a in graphs.items():
        m, n = a.shape
        ap = relabeled(a)[0]
        nat = ckern.prepare(sblas_torch.to_device(a, dev))
        rel = ckern.prepare(sblas_torch.to_device(ap, dev))
        sp = torch.sparse_csr_tensor(
            on_card(a.indptr), on_card(a.indices), on_card(a.data),
            size=a.shape)
        longest = int(a.row_lengths.max(initial=0))
        for k in (1, 8, 32):
            x0 = on_card(vec(n, k))
            row = {
                "kernel_us": us(lambda x, x0: ckern.spmm_csr(
                    nat, x, EPS, 1.0, x0), x0),
                "kernel_relabeled_us": us(lambda x, x0: ckern.spmm_csr(
                    rel, x, EPS, 1.0, x0), x0),
                "plain_us": us(lambda x, x0: ckern.spmm_csr_reference(
                    nat, x, EPS, 1.0, x0), x0, **few)}
            nbytes = csr_stream_bytes(m, a.nnz, 4) + (n + 2 * m) * k * 4
            row["bound_us"], row["bound_by"] = bound_us(nbytes,
                                                        2 * a.nnz * k)
            if k == 1:
                v0 = x0.view(-1)
                row["cusparse_us"] = us(lambda x, x0: torch.addmv(
                    x0, sp, x, beta=1.0, alpha=EPS), v0)
                routes = {
                    r: bench_spmv(a, method=r, device=dev,
                                  baseline=False).seconds_per_iter * 1e6
                    for r in ("csr", "merge", "pseg")}
                # the csr kernel's time per serial step of its longest row
                # (the SpMV rule's CSR_STEP_NS)
                row["csr_walk_steps"] = longest / kern.group_size(m, a.nnz)
                row["csr_ns_per_step"] = 1e3 * routes["csr"] / \
                    row["csr_walk_steps"]
                picked = _get_plan(a, "auto").method
            else:
                row["cusparse_us"] = us(lambda x, x0: torch.addmm(
                    x0, sp, x, beta=1.0, alpha=EPS), x0)
                routes = route_us(a, k, ("merge", "spmv_passes") + (
                    ("pseg",) if k == 8 else ()))
                prices = SpmmPlan.prices(a, k)
                free = torch.cuda.mem_get_info(dev)[0]
                row["block_stream_mb"] = prices["block_stream"] / 1e6
                if prices["block_stream"] <= free // 2:
                    routes.update(route_us(a, k, ("block",)))
                picked = spmm_plan(a, "auto", k_hint=k).method
                row["x_gather_fit"] = x_gather_fit(a, k, routes["merge"])
            graph_timings[(name, k)] = row
            emit({"phase": "graph_timing", "matrix": name, "k": k,
                  "card": card, "nnz": a.nnz, "longest_row": longest, **row,
                  "route_us": routes, "rule_picked": picked,
                  "faster_route": min(routes, key=routes.get)})
            del x0
        del nat, rel, sp

    # 6c. the share size: the nnz-balanced kernel at each unit of merged-path
    # items on both graphs, K = 1 and 8, each unit checked against the
    # plain version before it is timed
    for name, a in graphs.items():
        t = sblas_torch.to_device(a, dev)
        sweep, errs = {}, {}
        for k in (1, 8):
            x0 = on_card(vec(a.shape[1], k))
            for unit in (256, 384, 512, 1024, 2048):
                op = ckern.prepare(t, unit)
                errs[f"{unit},K={k}"] = check_plain(
                    "spmm_csr", f"{name} unit={unit} K={k}",
                    ckern.spmm_csr(op, x0, 2.5),
                    ckern.spmm_csr_reference(op, x0, 2.5))
                sweep[f"{unit},K={k}"] = us(
                    lambda x, x0, op=op: ckern.spmm_csr(op, x, EPS, 1.0, x0),
                    x0)
                del op
        emit({"phase": "unit_sweep", "matrix": name, "card": card,
              "rule_unit": ckern.UNIT, "rule_unit_spmv": ckern.UNIT_SPMV,
              "us": sweep, "rel_err": errs})
        del t, x0
    # a matrix of a few shares: the kernel's time for one wave of shares,
    # the SpMV rule's MERGE_SHARE_NS
    small = datasets.banded(300, 5)
    t = sblas_torch.to_device(small, dev)
    x0 = on_card(vec(300, 1))
    one_wave = {}
    for unit in (256, 512, 1024, 2048):
        op = ckern.prepare(t, unit)
        check_plain("spmm_csr", f"banded(300,5) unit={unit}",
                    ckern.spmm_csr(op, x0, 2.5),
                    ckern.spmm_csr_reference(op, x0, 2.5))
        one_wave[unit] = us(
            lambda x, x0, op=op: ckern.spmm_csr(op, x, EPS, 1.0, x0), x0)
    emit({"phase": "unit_sweep", "matrix": "banded(300,5)", "card": card,
          "one_wave_us": one_wave, "rule_share_ns": MERGE_SHARE_NS})
    del t, x0, op

    # 7. SpMM timing on the FEM matrices: the block kernel, its plain
    # version, cuSPARSE, the bound and the other routes -----------------
    spmm_timings = {}
    fem_rows = [(name, a, k, 128) for name, a in fem_suite.items()
                for k in (8, 32)]
    fem_rows += [(name, fem_suite[name], 8, 64) for name in ("consph",
                                                             "pdb1HYS")]
    for name, a, k, br in fem_rows:
        rec = bench_spmm(a, k, method="block", block_rows=br, ratio_pairs=3,
                         device=dev)
        row = {"kernel_us": rec.seconds_per_iter * 1e6,
               "bound_us": rec.extra["bound_us"],
               "bound_by": rec.extra["bound_by"],
               "cusparse_us": rec.extra["baseline_us"]}
        op = spmm_plan(a, "block", k_hint=k, block_rows=br)._op
        x0 = on_card(vec(a.shape[1], k))
        row["plain_us"] = us(lambda x, x0: bkern.spmm_bsr_reference(
            op, x, EPS, 1.0, x0), x0)
        del op, x0
        extra = {}
        if br == 128:
            rec16 = bench_spmm(a, k, method="block",
                               value_dtype=torch.bfloat16, device=dev,
                               baseline=False)
            routes = {"block": row["kernel_us"]}
            for r in ("merge", "spmv_passes"):
                routes[r] = bench_spmm(a, k, method=r, device=dev,
                                       baseline=False).seconds_per_iter * 1e6
            extra = {"kernel_bf16_us": rec16.seconds_per_iter * 1e6,
                     "kernel_bf16_gbps": rec16.gbps,
                     "bound_bf16_us": rec16.extra["bound_us"],
                     "route_us": routes,
                     "rule_picked": spmm_plan(a, "auto", k_hint=k).method,
                     "faster_route": min(routes, key=routes.get),
                     "x_gather_fit": x_gather_fit(a, k, routes["merge"])}
        spmm_timings[(name, k, br)] = row
        emit({"phase": "spmm_timing", "matrix": name, "k": k,
              "block_rows": br, "card": card, **row, **extra,
              "kernel_gflops": rec.gflops, "kernel_gbps": rec.gbps,
              "pct_stream": rec.extra["pct_stream"],
              "stream_gbps": rec.extra["stream_gbps"],
              "bytes_per_iter": rec.bytes, "rel_err": rec.extra["rel_err"],
              "ratio_pairs": rec.extra["ratio_pairs"]})
    # the FEM band at K = 8: its blocks (12.8 GB) are priced, not packed
    routes = {r: bench_spmm(fem, 8, method=r, device=dev,
                            baseline=False).seconds_per_iter * 1e6
              for r in ("merge", "spmv_passes")}
    emit({"phase": "spmm_timing", "matrix": "fem-band-1M-112M", "k": 8,
          "card": card, "route_us": routes,
          "block_stream_mb": SpmmPlan.prices(fem, 8)["block_stream"] / 1e6,
          "rule_picked": spmm_plan(fem, "auto", k_hint=8).method,
          "faster_route": min(routes, key=routes.get),
          "x_gather_fit": x_gather_fit(fem, 8, routes["merge"])})

    # 7b. the solves: the sync-free kernel through its plan (K = 1, 8 and
    # the backsolve, tickets level by level, small levels grouped), its
    # plain version, the bound, ns per level and cuSPARSE's
    # triangular_solve; beside it the same kernel with tickets in plain
    # level order and in row order (its earlier orders); the Jacobi sweeps
    # on band-parallel ------------------------------------------------------
    def order_us(op, b0, turns=2, **kw):
        """Graph-timed us of the solve kernel on ``op`` with its tickets
        (levels, small ones grouped), in plain level order and in row
        order, in turns (ticket, level, row, ticket, ...), as its plan is
        timed (1 and 4 solves, best of 3 each; ``kw`` overrides)."""
        kw = {"iters_lo": 1, "iters_hi": 4, **kw}
        level = {**op, "perm": torch.from_numpy(skern.ticket_order(
            op["levels"], op["lower"], 0)).to(op["perm"].device)}
        out = {}
        for order, o in (("ticket_us", op), ("level_us", level),
                         ("row_order_us", skern.row_order(op))) * turns:
            t_us = us(lambda x, b0, o=o: skern.sptrsv_csr(o, b0 + EPS * x),
                      b0, **kw)
            out[order] = min(out.get(order, t_us), t_us)
        return out

    solve_timings = {}
    # the plain version runs ~8 torch calls a level: one and two solves
    solve_few = {"iters_lo": 1, "iters_hi": 2, "repeats": 1}
    solve_rows = [(name, l, vec) for name, l in factors.items()]
    solve_rows += [(name + " f64", factors64[name], vec64)
                   for name in ("band-parallel", "chol-nd-poisson2d-1000")]
    for name, l, mk in solve_rows:
        lt = as_csr(l, True)
        # on the default device: the plans the main path built and cached
        recs = {"K=1": bench_sptrsv(l), "K=8": bench_sptrsm(l, 8),
                "trans K=1": bench_sptrsv(lt, lower=False)}
        if name == "band-parallel":
            recs["jacobi K=1"] = bench_sptrsv(l, method="jacobi",
                                              baseline=False)
        op = sptrsv_plan(l)._op
        plain_us = {k: us(lambda x, b0: skern.sptrsv_csr_reference(
            op, b0 + EPS * x), on_card(mk(l.shape[0], k)), **solve_few)
            for k in (1, 8)}
        orders = {"K=1": order_us(op, on_card(mk(l.shape[0], 1))),
                  "K=8": order_us(op, on_card(mk(l.shape[0], 8))),
                  "trans K=1": order_us(sptrsv_plan(lt, lower=False)._op,
                                        on_card(mk(l.shape[0], 1)))}
        del op
        rows = {}
        for label, rec in recs.items():
            e = rec.extra
            rows[label] = {
                "method": e["method"], "us": rec.seconds_per_iter * 1e6,
                "bound_us": e["bound_us"], "bound_by": e["bound_by"],
                "bytes": rec.bytes, "gbps": rec.gbps,
                "ns_per_level": e["ns_per_level"],
                "levels_per_s": e["levels_per_s"], "nlevels": e["nlevels"],
                "rel_err": e["rel_err"],
                "cusparse_us": e.get("baseline_us"),
                "cusparse_error": e.get("baseline_error"),
                **orders.get(label, {}),
                **({"sweeps": e["sweeps"]} if "sweeps" in e else {})}
        rows["K=1"]["plain_us"], rows["K=8"]["plain_us"] = plain_us[1], \
            plain_us[8]
        solve_timings[name] = rows
        emit({"phase": "sptrsv_timing", "matrix": name, "card": card,
              "dtype": np.dtype(l.dtype).name, "n": l.shape[0],
              "nnz": l.nnz, **rows})

    # 7b'. the ticket order's group size: the solve kernel with small
    # levels merged into groups of at most 512 .. 4,096 rows (the rule's
    # GROUP_ROWS among them), each order checked bit for bit first
    group_sweep = {}
    for name, k in (("band-parallel", 1), ("band-parallel", 8),
                    ("chol-nd-poisson2d-120", 1),
                    ("chol-nd-poisson2d-1000", 1)):
        op = sptrsv_plan(factors[name])._op
        b0 = on_card(vec(op["shape"][0], k))
        got = skern.sptrsv_csr(op, b0)
        row = {}
        for g in (512, 1024, 2048, 4096):
            o = {**op, "perm": on_card(skern.ticket_order(
                op["levels"], True, g))}
            if not torch.equal(skern.sptrsv_csr(o, b0), got):
                raise RuntimeError(f"{name} group {g}: other bits")
            row[g] = us(lambda x, b0, o=o: skern.sptrsv_csr(
                o, b0 + EPS * x), b0, iters_lo=1, iters_hi=4)
        group_sweep[f"{name} K={k}"] = row
        del op, b0, got
    emit({"phase": "ticket_group_sweep", "card": card,
          "rule_group_rows": skern.GROUP_ROWS, "us": group_sweep})

    # 7c. the solvers: CG + Jacobi in f64 on the 1M-row grid to
    # convergence, and IC(0)-CG (the same grid), ILU(0)-BiCGSTAB and
    # ILU(0)-GMRES(30) (convection_diffusion(1000)) in f64 for 30 iterations
    # each (a cut depth): ms per iteration split into the SpMV, the two
    # triangular solves and the rest, the kernels' share of the wall time,
    # and the reported residual against the true one --------------------
    solver_timings = {}
    c1m = datasets.convection_diffusion(1000, dtype=np.float64)
    p1m = grid[np.float64]
    runs = [("cg+jacobi", solvers.cg, p1m, solvers.jacobi(p1m),
             {"tol": 1e-8, "maxiter": 20000}),
            ("ic0-cg", solvers.cg, p1m, solvers.ichol(p1m),
             {"tol": 0.0, "maxiter": 30}),
            ("ilu0-bicgstab", solvers.bicgstab, c1m, solvers.ilu(c1m),
             {"tol": 0.0, "maxiter": 30}),
            ("ilu0-gmres(30)", solvers.gmres, c1m, None,
             {"tol": 0.0, "maxiter": 30, "restart": 30})]
    for label, solve, a, m_, kw in runs:
        if m_ is None:          # GMRES shares BiCGSTAB's ILU(0) factor
            m_ = runs[2][3]
        row = bench_solver(solve, a, b1m, M=m_, **kw)
        if label in ("ic0-cg", "ilu0-bicgstab"):
            # the factors' solves in ticket order against row order: the
            # same bits, and the three orders' times in this call
            b0 = on_card(b1m)
            for side, sp in (("fwd", m_.fwd), ("bwd", m_.bwd)):
                got = skern.sptrsv_csr(sp._op, b0)
                if not torch.equal(skern.sptrsv_csr(
                        skern.row_order(sp._op), b0), got):
                    raise RuntimeError(f"{label} {side}: ticket order "
                                       "differs from row order")
                # row order takes ~0.27 s a solve here: one turn, one
                # sample of one against two solves
                row[f"{side}_order_us"] = order_us(sp._op, b0, 1,
                                                   **solve_few)
            del b0
        agree = abs(row["rel_residual"] - row["true_rel_residual"]) / \
            row["true_rel_residual"]
        if kw["tol"] and not row["true_rel_residual"] <= 2 * kw["tol"]:
            raise RuntimeError(f"{label}: true residual "
                               f"{row['true_rel_residual']}")
        if not kw["tol"] and not agree <= 1e-6:
            raise RuntimeError(f"{label}: reported residual "
                               f"{row['rel_residual']} against the true "
                               f"{row['true_rel_residual']}")
        row["residual_agreement"] = agree
        solver_timings[label] = row
        emit({"phase": "solver_timing", "solver": label, "card": card,
              "matrix": "poisson2d(1000)" if a is p1m
              else "convection_diffusion(1000)", **row})
    del runs

    # 8. lanes-per-row sweep: every width the csr kernel takes, on cant in
    # f32, bf16 and f64 and on the FEM band in f64 (an earlier f32 sweep of
    # the band found G = 8 fastest there too), each width checked against
    # the plain version before it is timed -------------------------------
    sweeps = [("cant", cant, vd) for vd in (torch.float32, torch.bfloat16)]
    sweeps += [("cant", cant64, torch.float64),
               ("fem-band-1M-112M", fem64, torch.float64)]
    for name, a, vd in sweeps:
        mk = vec64 if vd == torch.float64 else vec
        x, y = on_card(mk(a.shape[1])), on_card(mk(a.shape[0]))
        op = kern.prepare(sblas_torch.to_device(a, dev, vd))
        sweep, errs = {}, {}
        for g in kern.GROUPS:
            opg = {**op, "group": g}
            errs[g] = against_plain(f"{name} {vd} G={g}", opg, x, 2.5, -0.5,
                                    y)
            sweep[g] = us(lambda c, x0: kern.spmv_csr(opg, c, EPS, 1.0, x0),
                          x)
        emit({"phase": "group_sweep", "matrix": name, "card": card,
              "values": str(vd)[6:], "rule_group": op["group"],
              "us": sweep, "rel_err": errs})
        del op, x, y

    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "suite_generate_s": suite_gen_s, "fem_generate_s": fem_gen_s,
          "graph_generate_s": graph_gen_s, "relabel_s": relabel_s,
          "factor_generate_s": factor_gen_s,
          "solve_golden_s": solve_golden_s,
          "solver_generate_s": solver_gen_s})
    main = spmm_timings[("consph", 8, 128)]
    tw = graph_timings[("twitter7@0.02", 8)]
    big = solve_timings["chol-nd-poisson2d-1000"]["K=1"]
    big64 = solve_timings["chol-nd-poisson2d-1000 f64"]["K=1"]
    cant_f64 = timings["cant f64"]
    uk_f64 = timings["uk-2002@0.05 f64"]
    emit({"kernels": [
        {"name": "spmv_csr", "route": "cuda",
         "source": "sblas_torch/csrc/spmv_csr.cu",
         "replaces": "sblas/ops/kernels/spmv_pallas.py:55",
         "launches": launches["spmv_csr"], "max_abs_err": max_abs["spmv_csr"],
         "ms": timings["cant"]["kernel_us"] / 1e3,
         "plain_ms": timings["cant"]["plain_us"] / 1e3,
         "bound_ms": timings["cant"]["bound_us"] / 1e3, "bound_by": "bytes",
         "library_ms": timings["cant"]["cusparse_us"] / 1e3,
         "shape": "cant f32"},
        {"name": "spmm_bsr", "route": "cuda",
         "source": "sblas_torch/csrc/spmm_bsr.cu",
         "replaces": ["sblas/ops/kernels/spmm_bsr_pallas.py:96",
                      "sblas/ops/kernels/spmm_bsr_pallas.py:44",
                      "sblas/ops/kernels/spmm_bsr_pallas.py:481"],
         "launches": launches["spmm_bsr"], "max_abs_err": max_abs["spmm_bsr"],
         "ms": main["kernel_us"] / 1e3, "plain_ms": main["plain_us"] / 1e3,
         "bound_ms": main["bound_us"] / 1e3, "bound_by": main["bound_by"],
         "library_ms": main["cusparse_us"] / 1e3,
         "shape": "consph f32 K=8"},
        {"name": "spmm_csr", "route": "cuda",
         "source": "sblas_torch/csrc/spmm_csr.cu",
         "replaces": ["sblas/ops/kernels/spmv_pseg.py:37",
                      "sblas/ops/kernels/spmm_pseg.py:134",
                      "sblas/ops/kernels/spmm_pseg.py:350",
                      "sblas/ops/kernels/spmm_pallas.py:30"],
         "launches": launches["spmm_csr"], "max_abs_err": max_abs["spmm_csr"],
         "ms": tw["kernel_us"] / 1e3, "plain_ms": tw["plain_us"] / 1e3,
         "bound_ms": tw["bound_us"] / 1e3, "bound_by": tw["bound_by"],
         "library_ms": tw["cusparse_us"] / 1e3,
         "shape": "twitter7@0.02 f32 K=8, natural order (route merge)"},
        {"name": "sptrsv_csr", "route": "cuda",
         "source": "sblas_torch/csrc/sptrsv_csr.cu",
         "replaces": ["sblas/ops/kernels/sptrsv_pallas.py:510",
                      "sblas/ops/kernels/sptrsv_pallas.py:1045"],
         "launches": launches["sptrsv_csr"],
         "max_abs_err": max_abs["sptrsv_csr"],
         "ms": big["us"] / 1e3, "plain_ms": big["plain_us"] / 1e3,
         "bound_ms": big["bound_us"] / 1e3, "bound_by": big["bound_by"],
         "library_ms": None if big["cusparse_us"] is None
         else big["cusparse_us"] / 1e3,
         "shape": "chol-nd-poisson2d-1000 (1M rows, 50.2M nnz) f32, K=1"},
        {"name": "spmv_csr_f64", "route": "cuda",
         "source": "sblas_torch/csrc/spmv_csr.cu",
         "replaces": "sblas/ops/kernels/spmv_wsell_ds.py:80",
         "launches": launches["spmv_csr_f64"],
         "max_abs_err": max_abs["spmv_csr_f64"],
         "ms": cant_f64["kernel_us"] / 1e3,
         "plain_ms": cant_f64["plain_us"] / 1e3,
         "bound_ms": cant_f64["bound_us"] / 1e3,
         "bound_by": cant_f64["bound_by"],
         "library_ms": cant_f64["cusparse_us"] / 1e3,
         "shape": "cant f64"},
        {"name": "spmm_csr_f64", "route": "cuda",
         "source": "sblas_torch/csrc/spmm_csr.cu",
         "replaces": ["sblas/ops/kernels/spmv_pseg.py:37",
                      "sblas/ops/kernels/spmm_pseg.py:134",
                      "sblas/ops/kernels/spmm_pseg.py:350",
                      "sblas/ops/kernels/spmm_pallas.py:30"],
         "launches": launches["spmm_csr_f64"],
         "max_abs_err": max_abs["spmm_csr_f64"],
         "ms": uk_f64["kernel_us"] / 1e3, "plain_ms": uk_f64["plain_us"] / 1e3,
         "bound_ms": uk_f64["bound_us"] / 1e3, "bound_by": uk_f64["bound_by"],
         "library_ms": uk_f64["cusparse_us"] / 1e3,
         "shape": "uk-2002@0.05 f64, K=1 (route merge, auto's f64 pick)"},
        {"name": "sptrsv_csr_f64", "route": "cuda",
         "source": "sblas_torch/csrc/sptrsv_csr.cu",
         "replaces": ["sblas/ops/kernels/sptrsv_ds.py:65",
                      "sblas/ops/kernels/sptrsv_ds.py:159"],
         "launches": launches["sptrsv_csr_f64"],
         "max_abs_err": max_abs["sptrsv_csr_f64"],
         "ms": big64["us"] / 1e3, "plain_ms": big64["plain_us"] / 1e3,
         "bound_ms": big64["bound_us"] / 1e3, "bound_by": big64["bound_by"],
         "library_ms": None if big64["cusparse_us"] is None
         else big64["cusparse_us"] / 1e3,
         "shape": "chol-nd-poisson2d-1000 (1M rows, 50.2M nnz) f64, K=1"}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
