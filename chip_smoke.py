#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sblas_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

It builds the port's CUDA kernels from the sources in the checkout and
holds each against its plain torch version on the card. It drives the three
main paths a user calls, each with every kernel launch count set to 0 just
before it and read just after:

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

checks every result against scipy, and fails where the route the rule
picked launched no kernel. It times each kernel beside its plain version,
its bound (bytes at the card's data-sheet memory rate, or flops at its fp32
rate), cuSPARSE and a STREAM triad, times the routes of each matrix
against each other (``rule_picked``, ``faster_route``), times the SpMV
csr kernel at every lanes-per-row width it takes (each width checked
first), and times each solve beside its plain version, its bound, its ns
per level and cuSPARSE's ``triangular_solve``. It imports only the port.

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
    from sblas_torch.bench_lib import (EPS, SOLVE_TOL, bench_spmm,
                                       bench_spmv, bench_sptrsm,
                                       bench_sptrsv)
    from sblas_torch.golden import (KERNEL_TOL, rel_err, spmm_golden,
                                    spmv_golden, sptrsm_golden,
                                    sptrsv_golden, value_tol)
    from sblas_torch.ops.common import as_csr, relabeled
    from sblas_torch.ops.kernels import _build
    from sblas_torch.ops.kernels import spmm_bsr as bkern
    from sblas_torch.ops.kernels import spmm_csr as ckern
    from sblas_torch.ops.kernels import sptrsv_csr as skern
    from sblas_torch.ops.kernels import spmv_csr as kern
    from sblas_torch.ops.spmm import SpmmPlan
    from sblas_torch.ops.spmm import _get_plan as spmm_plan
    from sblas_torch.ops.spmv import _get_plan, csr_stream_bytes
    from sblas_torch.ops.sptrsv import get_plan as sptrsv_plan
    from sblas_torch.retile_bsr import pack_bsr
    from sblas_torch.utils.backend import probe
    from sblas_torch.utils.timing import (FP32_FLOPS, HBM_BYTES_PER_S,
                                          measure_seconds_per_iter,
                                          stream_bandwidth)

    # the plain versions' products (torch.bmm) in full f32, stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    f32_tol = value_tol(torch.float32)
    t_start = time.perf_counter()
    kernels = {"spmv_csr": kern, "spmm_bsr": bkern, "spmm_csr": ckern,
               "sptrsv_csr": skern}

    def vec(*shape):
        return rng.standard_normal(shape).astype(np.float32)

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
    ptxas = [ln.strip() for ln in (log.read_text() if log.exists() else
                                   "").splitlines() if "registers" in ln
             or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib.name, "ptxas": ptxas})

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
    # Cholesky factor scaled up to 1M rows and 50M nonzeros
    factors, factor_gen_s = {}, {}
    t0 = time.perf_counter()
    factors["band-parallel"] = datasets.lower_triangular(
        62451, 30, bandwidth=4000, seed=1, dtype=np.float32)
    factor_gen_s["band-parallel"] = time.perf_counter() - t0
    for grid in (60, 120, 1000):
        t0 = time.perf_counter()
        factors[f"chol-nd-poisson2d-{grid}"] = datasets.cholesky_factor(
            datasets.poisson2d_nd(grid, dtype=np.float64), dtype=np.float32)
        factor_gen_s[f"chol-nd-poisson2d-{grid}"] = time.perf_counter() - t0
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

    def check_plain(kernel, label, got, want):
        torch.cuda.synchronize()
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if g.shape != w.shape or not np.isfinite(g).all():
            raise RuntimeError(f"{label}: bad kernel output")
        err = rel_err(g, w)
        max_abs[kernel] = max(max_abs[kernel],
                              float(np.max(np.abs(g - w), initial=0.0)))
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"{label}: kernel vs plain rel_err {err} > "
                               f"{KERNEL_TOL}")
        return err

    def against_plain(label, op, x, alpha, beta, yy):
        return check_plain("spmv_csr", label,
                           kern.spmv_csr(op, x, alpha, beta, yy),
                           kern.spmv_csr_reference(op, x, alpha, beta, yy))

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
        emit({"phase": "kernel_vs_plain", "kernel": "spmv_csr",
              "matrix": name, "nnz": a.nnz, "tol": KERNEL_TOL,
              "rel_err": errs})

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

    # 4c. the sync-free solve kernel vs its plain version on the card, on
    # each factor, lower (L) and upper (L^T, the backsolve), K = 1 and 8;
    # and the same bits on 20 repeats ------------------------------------
    for name, l in factors.items():
        errs, nlevels, t0 = {}, {}, time.perf_counter()
        for side, a, lower in (("L", l, True), ("L^T", as_csr(l, True),
                                                False)):
            op = sptrsv_plan(a, lower=lower)._op
            for k in (1, 8):
                b = on_card(vec(a.shape[0], k))
                got = skern.sptrsv_csr(op, b)
                errs[f"{side},K={k}"] = check_plain(
                    "sptrsv_csr", f"{name} {side} K={k}", got,
                    skern.sptrsv_csr_reference(op, b))
                if k == 1:
                    for _ in range(20):
                        if not torch.equal(skern.sptrsv_csr(op, b), got):
                            raise RuntimeError(f"{name} {side}: the solve "
                                               "changed from run to run")
            nlevels[side] = op["nlevels"]
            del op, b, got
        emit({"phase": "sptrsv_kernel_vs_plain", "matrix": name,
              "n": l.shape[0], "nnz": l.nnz, "nlevels": nlevels,
              "longest_row": int(l.row_lengths.max(initial=0)),
              "tol": KERNEL_TOL, "rel_err": errs, "repeats_bit_equal": 20,
              "seconds": time.perf_counter() - t0})

    # 5. the main paths, through the user's entry points: the route is the
    # rule's pick, and each call must launch that route's kernel ---------
    by_route = {"csr": kern, "rcm": kern, "merge": ckern, "pseg": ckern,
                "block": bkern}

    def check(res, name, label, call, plan_of, ref, tol):
        before = {mod: mod.LAUNCHES for mod in kernels.values()}
        out = call()
        torch.cuda.synchronize()
        plan = plan_of()
        route = plan._spmv.method if plan.method == "spmv_passes" \
            else plan.method
        mod = by_route[route]
        if mod.LAUNCHES == before[mod]:
            raise RuntimeError(f"{name} {label}: route {plan.method!r} "
                               f"({plan.route_reason}) launched no kernel")
        got = out.cpu().numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: bad output")
        err = rel_err(got, ref)
        if not err < tol:
            raise RuntimeError(f"{name} {label}: rel_err vs scipy {err} "
                               f">= {tol}")
        res[label] = {"rel_err": err, "tol": tol, "method": plan.method,
                      "route_reason": plan.route_reason}

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
        for mod in kernels.values():
            mod.LAUNCHES = 0

    def counts():
        torch.cuda.synchronize()
        return {name: mod.LAUNCHES for name, mod in kernels.items()}

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
    # kernel), the Cholesky backsolve (trans), and the Jacobi sweeps -------
    solve_tol = SOLVE_TOL[np.dtype(np.float32)]

    def check_solve(res, name, label, call, plan, ref, mod):
        before = mod.LAUNCHES
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if mod.LAUNCHES == before:
            raise RuntimeError(f"{name} {label}: route {plan.method!r} "
                               f"({plan.route_reason}) launched no kernel")
        got = out.cpu().numpy()
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: bad output")
        err = rel_err(got, ref)
        if not err < solve_tol:
            raise RuntimeError(f"{name} {label}: rel_err vs scipy {err} "
                               f">= {solve_tol}")
        res[label] = {"rel_err": err, "tol": solve_tol, "method": plan.method,
                      "route_reason": getattr(plan, "route_reason", None),
                      "nlevels": plan.nlevels, "seconds": seconds}

    reset()
    for name, l in factors.items():
        n = l.shape[0]
        b, bm = vec(n), vec(n, 8)
        lt = as_csr(l, True)
        res, t0 = {}, time.perf_counter()
        check_solve(res, name, "K=1", lambda: sblas_torch.sptrsv(l, b),
                    sptrsv_plan(l), sptrsv_golden(l, b), skern)
        check_solve(res, name, "K=8", lambda: sblas_torch.sptrsm(l, bm),
                    sptrsv_plan(l), sptrsm_golden(l, bm), skern)
        check_solve(res, name, "trans K=1",
                    lambda: sblas_torch.sptrsv(l, b, trans=True),
                    sptrsv_plan(lt, lower=False),
                    sptrsv_golden(lt, b, lower=False), skern)
        emit({"phase": "main_path", "path": "sptrsv", "matrix": name,
              "n": n, "nnz": l.nnz, "seconds": time.perf_counter() - t0,
              "checks": res})
    bp = factors["band-parallel"]
    b = vec(bp.shape[0])
    res = {}
    check_solve(res, "band-parallel", "jacobi K=1",
                lambda: sblas_torch.sptrsv(bp, b, method="jacobi"),
                sptrsv_plan(bp, method="jacobi"), sptrsv_golden(bp, b),
                by_route[sptrsv_plan(bp, method="jacobi")._e.method])
    emit({"phase": "main_path", "path": "sptrsv", "matrix": "band-parallel",
          "checks": res,
          "sweeps": sptrsv_plan(bp, method="jacobi").sweeps})
    sptrsv_launches = counts()
    emit({"phase": "launches", "path": "sptrsv", **sptrsv_launches})
    if sptrsv_launches["sptrsv_csr"] == 0:
        raise RuntimeError("the solves' main path never launched sptrsv_csr")
    launches = {name: launches[name] + sptrsv_launches[name]
                for name in kernels}

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
    def bound_us(nbytes, flops):
        bytes_s = nbytes / HBM_BYTES_PER_S
        flops_s = flops / FP32_FLOPS
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
        rec = bench_spmv(a, method="csr", ratio_pairs=5, device=dev)
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
        bound = max(rec.bytes / HBM_BYTES_PER_S, rec.flops / FP32_FLOPS)
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
    # the backsolve), its plain version, the bound, ns per level and
    # cuSPARSE's triangular_solve; the Jacobi sweeps on band-parallel ------
    solve_timings = {}
    # the plain version runs ~8 torch calls a level: one and two solves
    solve_few = {"iters_lo": 1, "iters_hi": 2, "repeats": 1}
    for name, l in factors.items():
        lt = as_csr(l, True)
        # on the default device: the plans the main path built and cached
        recs = {"K=1": bench_sptrsv(l), "K=8": bench_sptrsm(l, 8),
                "trans K=1": bench_sptrsv(lt, lower=False)}
        if name == "band-parallel":
            recs["jacobi K=1"] = bench_sptrsv(l, method="jacobi",
                                              baseline=False)
        op = sptrsv_plan(l)._op
        plain_us = {k: us(lambda x, b0: skern.sptrsv_csr_reference(
            op, b0 + EPS * x), on_card(vec(l.shape[0], k)), **solve_few)
            for k in (1, 8)}
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
                **({"sweeps": e["sweeps"]} if "sweeps" in e else {})}
        rows["K=1"]["plain_us"], rows["K=8"]["plain_us"] = plain_us[1], \
            plain_us[8]
        solve_timings[name] = rows
        emit({"phase": "sptrsv_timing", "matrix": name, "card": card,
              "n": l.shape[0], "nnz": l.nnz, **rows})

    # 8. lanes-per-row sweep on cant: every width the csr kernel takes,
    # each checked against the plain version before it is timed (an earlier
    # sweep of the FEM band found G = 8 fastest there too) ----------------
    for name, a in (("cant", cant),):
        x = on_card(vec(a.shape[1]))
        y = on_card(vec(a.shape[0]))
        for vd in (torch.float32, torch.bfloat16):
            op = kern.prepare(sblas_torch.to_device(a, dev, vd))
            sweep, errs = {}, {}
            for g in kern.GROUPS:
                opg = {**op, "group": g}
                errs[g] = against_plain(f"{name} {vd} G={g}", opg, x, 2.5,
                                        -0.5, y)
                sweep[g] = us(lambda c, x0: kern.spmv_csr(opg, c, EPS, 1.0,
                                                          x0), x)
            emit({"phase": "group_sweep", "matrix": name, "card": card,
                  "values": str(vd)[6:], "rule_group": op["group"],
                  "us": sweep, "rel_err": errs})
            del op
        del x, y

    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "suite_generate_s": suite_gen_s, "fem_generate_s": fem_gen_s,
          "graph_generate_s": graph_gen_s, "relabel_s": relabel_s,
          "factor_generate_s": factor_gen_s})
    main = spmm_timings[("consph", 8, 128)]
    tw = graph_timings[("twitter7@0.02", 8)]
    big = solve_timings["chol-nd-poisson2d-1000"]["K=1"]
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
         "shape": "chol-nd-poisson2d-1000 (1M rows, 50.2M nnz) f32, K=1"}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
