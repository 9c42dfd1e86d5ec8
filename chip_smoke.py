#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sblas_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

It builds the port's CUDA kernels from the sources in the checkout and
holds each against its plain torch version on the card. It drives the two
main paths a user calls, each with every kernel launch count set to 0 just
before it and read just after:

- SpMV (``sblas_torch.spmv``, ``method="auto"``, f32 ``y = alpha A x +
  beta y``) on the emulated SuiteSparse ``cant`` at full size and on a
  1M-row FEM band matrix with 110M nonzeros, through the ``csr`` kernel;
- SpMM (``sblas_torch.spmm``, ``method="auto"``, ``Y = alpha A X + beta
  Y``) on full-size ``cant``, ``consph`` and ``pdb1HYS`` at K = 8 and 32,
  which the bytes rule sends to the dense-block kernel, and on the FEM band
  at K = 8, which it sends to K passes of the ``csr`` kernel;

checks every result against scipy, times each kernel beside its plain
version, its bound, cuSPARSE and a STREAM triad, times the SpMM routes
against each other, and times the SpMV kernel at every lanes-per-row width
it takes (each width checked first). It imports only the port.

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 1

    import sblas_torch
    from sblas_torch import datasets
    from sblas_torch.bench_lib import EPS, bench_spmm, bench_spmv
    from sblas_torch.golden import (KERNEL_TOL, rel_err, spmm_golden,
                                    spmv_golden, value_tol)
    from sblas_torch.ops.common import as_csr
    from sblas_torch.ops.kernels import _build
    from sblas_torch.ops.kernels import spmm_bsr as bkern
    from sblas_torch.ops.kernels import spmv_csr as kern
    from sblas_torch.ops.spmm import _get_plan as spmm_plan
    from sblas_torch.ops.spmv import _get_plan
    from sblas_torch.retile_bsr import pack_bsr
    from sblas_torch.utils.backend import probe
    from sblas_torch.utils.timing import FP32_FLOPS, measure_seconds_per_iter

    # the plain versions' products (torch.bmm) in full f32, stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    f32_tol = value_tol(torch.float32)
    t_start = time.perf_counter()

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
    max_abs = {"spmv_csr": 0.0, "spmm_bsr": 0.0}

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

    # 5. the SpMV main path, through the user's entry point -------------
    def spmv_main_path(name, a):
        m, n = a.shape
        x, y0 = vec(n), vec(m)
        checks = []
        for label, kw, args, ref, tol in (
                ("f32", {}, (), spmv_golden(a, x), f32_tol),
                ("f32 alpha/beta", {}, (2.5, -0.5, y0),
                 spmv_golden(a, x, 2.5, -0.5, y0), f32_tol),
                ("bf16 values", {"value_dtype": torch.bfloat16}, (),
                 spmv_golden(a, x), value_tol(torch.bfloat16))):
            out = sblas_torch.spmv(a, x, *args, method="auto", **kw)
            plan = _get_plan(a, "auto", **kw)
            checks.append((label, plan, out, ref, tol))
        xt = vec(m)
        out = sblas_torch.spmv(a, xt, trans=True, method="auto")
        at = as_csr(a, True)    # the host transpose spmv built and cached
        checks.append(("f32 trans", _get_plan(at, "auto"), out,
                       spmv_golden(at, xt), f32_tol))
        return judge(name, checks, "csr")

    def judge(name, checks, route):
        res = {}
        for label, plan, out, ref, tol in checks:
            got = out.cpu().numpy()
            if plan.method != route:
                raise RuntimeError(f"{name} {label}: auto picked "
                                   f"{plan.method!r}, not {route!r} "
                                   f"({plan.route_reason})")
            if got.shape != ref.shape or not np.isfinite(got).all():
                raise RuntimeError(f"{name} {label}: bad output")
            err = rel_err(got, ref)
            if not err < tol:
                raise RuntimeError(f"{name} {label}: rel_err vs scipy {err} "
                                   f">= {tol}")
            res[label] = {"rel_err": err, "tol": tol, "method": plan.method}
        return res

    kern.LAUNCHES = 0
    bkern.LAUNCHES = 0
    res_cant = spmv_main_path("cant", cant)
    res_fem = spmv_main_path("fem-band-1M-112M", fem)
    torch.cuda.synchronize()
    spmv_launches = kern.LAUNCHES
    emit({"phase": "main_path", "path": "spmv", "matrix": "cant",
          "shape": cant.shape, "nnz": cant.nnz, "checks": res_cant})
    emit({"phase": "main_path", "path": "spmv", "matrix": "fem-band-1M-112M",
          "shape": fem.shape, "nnz": fem.nnz, "generate_s": fem_gen_s,
          "checks": res_fem})
    if spmv_launches == 0:
        raise RuntimeError("the SpMV main path never launched the csr kernel")
    emit({"phase": "launches", "path": "spmv", "spmv_csr": spmv_launches,
          "spmm_bsr": bkern.LAUNCHES})

    # 6. the SpMM main path, through the user's entry point -------------
    def spmm_main_path(name, a, k, route, extra_checks):
        m, n = a.shape
        x, y0 = vec(n, k), vec(m, k)
        t0 = time.perf_counter()
        out = sblas_torch.spmm(a, x, 2.5, -0.5, y0, method="auto", k_hint=k)
        plan_s = time.perf_counter() - t0
        checks = [("f32 alpha/beta", spmm_plan(a, "auto", k_hint=k), out,
                   spmm_golden(a, x, 2.5, -0.5, y0), f32_tol)]
        if "bf16" in extra_checks:
            out = sblas_torch.spmm(a, x, method="auto", k_hint=k,
                                   value_dtype=torch.bfloat16)
            checks.append(("bf16 values", spmm_plan(
                a, "auto", k_hint=k, value_dtype=torch.bfloat16), out,
                spmm_golden(a, x), value_tol(torch.bfloat16)))
        if "trans" in extra_checks:
            xt = vec(m, k)
            out = sblas_torch.spmm(a, xt, trans=True, method="auto",
                                   k_hint=k)
            at = as_csr(a, True)
            checks.append(("f32 trans", spmm_plan(at, "auto", k_hint=k), out,
                           spmm_golden(at, xt), f32_tol))
        res = judge(f"{name} K={k}", checks, route)
        plan = checks[0][1]
        emit({"phase": "main_path", "path": "spmm", "matrix": name, "k": k,
              "nnz": a.nnz, "route_reason": plan.route_reason,
              "first_call_s": plan_s, "checks": res})

    kern.LAUNCHES = 0
    bkern.LAUNCHES = 0
    for name, a in fem_suite.items():
        for k in (8, 32):
            spmm_main_path(name, a, k, "block",
                           {"bf16"} | ({"trans"} if name == "cant" else set()))
    torch.cuda.synchronize()
    block_launches, csr_launches_before_passes = bkern.LAUNCHES, kern.LAUNCHES
    spmm_main_path("fem-band-1M-112M", fem, 8, "spmv_passes", set())
    torch.cuda.synchronize()
    spmm_launches = {"spmm_bsr": bkern.LAUNCHES, "spmv_csr": kern.LAUNCHES}
    emit({"phase": "launches", "path": "spmm", **spmm_launches,
          "spmv_csr_in_spmv_passes": kern.LAUNCHES - csr_launches_before_passes})
    if block_launches == 0:
        raise RuntimeError("the SpMM main path never launched the block kernel")
    if kern.LAUNCHES == csr_launches_before_passes:
        raise RuntimeError("spmv_passes never launched the csr kernel")

    # 7. SpMV timing ----------------------------------------------------
    timings = {}
    for name, a in (("cant", cant), ("fem-band-1M-112M", fem)):
        rec = bench_spmv(a, method="auto", ratio_pairs=5, device=dev)
        rec16 = bench_spmv(a, method="auto", value_dtype=torch.bfloat16,
                           device=dev, baseline=False)
        t = sblas_torch.to_device(a, dev)
        x0 = on_card(vec(a.shape[1]))
        plain = measure_seconds_per_iter(
            lambda x, x0: kern.spmv_csr_reference(t, x, EPS, 1.0, x0),
            x0, x0)
        # what an eager caller of the entry point waits per call, host
        # Python included (the graph-timed numbers above leave it out)
        sblas_torch.spmv(a, x0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            sblas_torch.spmv(a, x0)
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) / 200
        bound = max(rec.bytes / (rec.extra["stream_gbps"] * 1e9),
                    rec.flops / FP32_FLOPS)
        timings[name] = {"kernel_us": rec.seconds_per_iter * 1e6,
                         "plain_us": plain * 1e6, "bound_us": bound * 1e6,
                         "cusparse_us": rec.extra["baseline_us"]}
        emit({"phase": "timing", "kernel": "spmv_csr", "matrix": name,
              "card": card,
              "kernel_us": rec.seconds_per_iter * 1e6, "kernel_gbps": rec.gbps,
              "pct_stream": rec.extra["pct_stream"],
              "stream_gbps": rec.extra["stream_gbps"],
              "bytes_per_iter": rec.bytes, "bound_us": bound * 1e6,
              "plain_us": plain * 1e6,
              "eager_spmv_us_per_call": eager * 1e6,
              "cusparse_us": rec.extra["baseline_us"],
              "kernel_bf16_us": rec16.seconds_per_iter * 1e6,
              "kernel_bf16_gbps": rec16.gbps,
              "rel_err": rec.extra["rel_err"],
              "ratio_pairs": rec.extra["ratio_pairs"]})
        del t, x0

    # 8. SpMM timing: the block kernel, its plain version, cuSPARSE and the
    # other route, at the main path's shapes ----------------------------
    spmm_timings = {}
    for name, a in fem_suite.items():
        for k in (8, 32):
            rec = bench_spmm(a, k, method="auto", ratio_pairs=3, device=dev)
            if rec.extra["method"] != "block":
                raise RuntimeError(f"{name} K={k}: auto picked "
                                   f"{rec.extra['method']!r}")
            rec16 = bench_spmm(a, k, method="auto",
                               value_dtype=torch.bfloat16, device=dev,
                               baseline=False)
            passes = bench_spmm(a, k, method="spmv_passes", device=dev,
                                baseline=False)
            op = spmm_plan(a, "auto", k_hint=k)._op
            x0 = on_card(vec(a.shape[1], k))
            plain = measure_seconds_per_iter(
                lambda x, x0: bkern.spmm_bsr_reference(op, x, EPS, 1.0, x0),
                x0, x0)
            kernel_us = rec.seconds_per_iter * 1e6
            passes_us = passes.seconds_per_iter * 1e6
            row = {"kernel_us": kernel_us, "plain_us": plain * 1e6,
                   "bound_us": rec.extra["bound_us"],
                   "bound_by": rec.extra["bound_by"],
                   "cusparse_us": rec.extra["baseline_us"]}
            spmm_timings[(name, k)] = row
            emit({"phase": "spmm_timing", "matrix": name, "k": k,
                  "card": card, **row,
                  "kernel_gflops": rec.gflops, "kernel_gbps": rec.gbps,
                  "pct_stream": rec.extra["pct_stream"],
                  "stream_gbps": rec.extra["stream_gbps"],
                  "bytes_per_iter": rec.bytes,
                  "kernel_bf16_us": rec16.seconds_per_iter * 1e6,
                  "kernel_bf16_gbps": rec16.gbps,
                  "bound_bf16_us": rec16.extra["bound_us"],
                  "spmv_passes_us": passes_us,
                  "spmv_passes_bytes": passes.bytes,
                  "rule_picked": "block",
                  "faster_route": "block" if kernel_us <= passes_us
                  else "spmv_passes",
                  "rel_err": rec.extra["rel_err"],
                  "route_reason": rec.extra["route_reason"],
                  "ratio_pairs": rec.extra["ratio_pairs"]})
            del op, x0

    # 9. lanes-per-row sweep: every width the csr kernel takes, each
    # checked against the plain version before it is timed --------------
    for name, a in (("cant", cant), ("fem-band-1M-112M", fem)):
        x = on_card(vec(a.shape[1]))
        y = on_card(vec(a.shape[0]))
        for vd in (torch.float32, torch.bfloat16):
            op = kern.prepare(sblas_torch.to_device(a, dev, vd))
            us, errs = {}, {}
            for g in kern.GROUPS:
                opg = {**op, "group": g}
                errs[g] = against_plain(f"{name} {vd} G={g}", opg, x, 2.5,
                                        -0.5, y)
                us[g] = 1e6 * measure_seconds_per_iter(
                    lambda c, x0: kern.spmv_csr(opg, c, EPS, 1.0, x0), x, x)
            emit({"phase": "group_sweep", "matrix": name, "card": card,
                  "values": str(vd)[6:], "rule_group": op["group"],
                  "us": us, "rel_err": errs})
            del op
        del x, y

    main = spmm_timings[("consph", 8)]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "suite_generate_s": suite_gen_s})
    emit({"kernels": [
        {"name": "spmv_csr", "route": "cuda",
         "source": "sblas_torch/csrc/spmv_csr.cu",
         "replaces": "sblas/ops/kernels/spmv_pallas.py:55",
         "launches": spmv_launches, "max_abs_err": max_abs["spmv_csr"],
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
         "launches": block_launches, "max_abs_err": max_abs["spmm_bsr"],
         "ms": main["kernel_us"] / 1e3, "plain_ms": main["plain_us"] / 1e3,
         "bound_ms": main["bound_us"] / 1e3, "bound_by": main["bound_by"],
         "library_ms": main["cusparse_us"] / 1e3,
         "shape": "consph f32 K=8"}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
