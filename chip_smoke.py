#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sblas_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of the repository

It builds the port's CUDA kernel from the sources in the checkout, holds it
against its plain torch version on the card, drives the main path
(``sblas_torch.spmv`` with ``method="auto"``, f32 ``y = alpha A x + beta y``)
on the emulated SuiteSparse ``cant`` at full size and on a 1M-row FEM band
matrix with 110M nonzeros, checks both against scipy, times the kernel
beside its plain version, cuSPARSE and a STREAM triad, and times the kernel
at every lanes-per-row width it takes (each width checked first).
It imports only the port: ``sblas_torch`` and its re-exports.

Output: one JSON line per phase; a ``{"kernels": [...]}`` line; the card's
``name, power.limit`` as nvidia-smi prints it; and last
``{"ok": true, "device": {...}}``. Any failed phase raises, and the script
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
    from sblas_torch.bench_lib import EPS, bench_spmv
    from sblas_torch.golden import KERNEL_TOL, rel_err, spmv_golden, value_tol
    from sblas_torch.ops.common import as_csr
    from sblas_torch.ops.kernels import _build
    from sblas_torch.ops.kernels import spmv_csr as kern
    from sblas_torch.ops.spmv import _get_plan
    from sblas_torch.utils.backend import probe
    from sblas_torch.utils.timing import measure_seconds_per_iter

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    f32_tol = value_tol(torch.float32)

    def vec(k):
        return rng.standard_normal(k).astype(np.float32)

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

    # 3. kernel vs its plain version on the card ------------------------
    cant = datasets.emulate("cant", dtype=np.float32)
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
    max_abs = 0.0

    def against_plain(label, op, x, alpha, beta, yy):
        nonlocal max_abs
        got = kern.spmv_csr(op, x, alpha, beta, yy)
        want = kern.spmv_csr_reference(op, x, alpha, beta, yy)
        torch.cuda.synchronize()
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if g.shape != w.shape or not np.isfinite(g).all():
            raise RuntimeError(f"{label}: bad kernel output")
        err = rel_err(g, w)
        max_abs = max(max_abs, float(np.max(np.abs(g - w), initial=0.0)))
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"{label}: kernel vs plain rel_err {err} > "
                               f"{KERNEL_TOL}")
        return err

    for name, a in cases.items():
        x = torch.from_numpy(vec(a.shape[1])).to(dev)
        y = torch.from_numpy(vec(a.shape[0])).to(dev)
        errs = {}
        for vd in (torch.float32, torch.bfloat16):
            op = kern.prepare(sblas_torch.to_device(a, dev, vd))
            for alpha, beta, yy in ((2.5, -0.5, y), (1.0, 0.0, None)):
                label = f"{str(vd)[6:]},alpha={alpha}"
                errs[label] = against_plain(f"{name} {label}", op, x, alpha,
                                            beta, yy)
            del op
        emit({"phase": "kernel_vs_plain", "matrix": name, "nnz": a.nnz,
              "tol": KERNEL_TOL, "rel_err": errs})

    # 4-5. the main path, through the user's entry point ----------------
    def main_path(name, a):
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
        res = {}
        for label, plan, out, ref, tol in checks:
            got = out.cpu().numpy()
            if plan.method != "csr":
                raise RuntimeError(f"{name} {label}: auto picked "
                                   f"{plan.method!r}, not 'csr'")
            if got.shape != ref.shape or not np.isfinite(got).all():
                raise RuntimeError(f"{name} {label}: bad output")
            err = rel_err(got, ref)
            if not err < tol:
                raise RuntimeError(f"{name} {label}: rel_err vs scipy {err} "
                                   f">= {tol}")
            res[label] = {"rel_err": err, "tol": tol, "method": plan.method}
        return res

    kern.LAUNCHES = 0
    res_cant = main_path("cant", cant)
    res_fem = main_path("fem-band-1M-112M", fem)
    torch.cuda.synchronize()
    launches = kern.LAUNCHES
    emit({"phase": "main_path", "matrix": "cant", "shape": cant.shape,
          "nnz": cant.nnz, "checks": res_cant})
    emit({"phase": "main_path", "matrix": "fem-band-1M-112M",
          "shape": fem.shape, "nnz": fem.nnz, "generate_s": fem_gen_s,
          "checks": res_fem})
    if launches == 0:
        raise RuntimeError("the main path never launched the csr kernel")
    emit({"phase": "launches", "spmv_csr": launches})

    # 6. timing ---------------------------------------------------------
    timings = {}
    for name, a in (("cant", cant), ("fem-band-1M-112M", fem)):
        rec = bench_spmv(a, method="auto", ratio_pairs=5, device=dev)
        rec16 = bench_spmv(a, method="auto", value_dtype=torch.bfloat16,
                           device=dev, baseline=False)
        t = sblas_torch.to_device(a, dev)
        x0 = torch.from_numpy(vec(a.shape[1])).to(dev)
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
        timings[name] = {"kernel_us": rec.seconds_per_iter * 1e6,
                         "plain_us": plain * 1e6}
        emit({"phase": "timing", "matrix": name, "card": card,
              "kernel_us": rec.seconds_per_iter * 1e6, "kernel_gbps": rec.gbps,
              "pct_stream": rec.extra["pct_stream"],
              "stream_gbps": rec.extra["stream_gbps"],
              "bytes_per_iter": rec.bytes,
              "plain_us": plain * 1e6,
              "eager_spmv_us_per_call": eager * 1e6,
              "cusparse_us": rec.extra["baseline_us"],
              "kernel_bf16_us": rec16.seconds_per_iter * 1e6,
              "kernel_bf16_gbps": rec16.gbps,
              "rel_err": rec.extra["rel_err"],
              "ratio_pairs": rec.extra["ratio_pairs"]})
        del t, x0

    # 7. lanes-per-row sweep: every width the kernel takes, each checked
    # against the plain version before it is timed ----------------------
    for name, a in (("cant", cant), ("fem-band-1M-112M", fem)):
        x = torch.from_numpy(vec(a.shape[1])).to(dev)
        y = torch.from_numpy(vec(a.shape[0])).to(dev)
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

    emit({"kernels": [{
        "name": "spmv_csr", "route": "cuda",
        "source": "sblas_torch/csrc/spmv_csr.cu",
        "replaces": "sblas/ops/kernels/spmv_pallas.py:55",
        "launches": launches, "max_abs_err": max_abs,
        "ms": timings["cant"]["kernel_us"] / 1e3,
        "plain_ms": timings["cant"]["plain_us"] / 1e3}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
