"""The port imports on CPU-only torch, without JAX, nvcc or triton, and
without the JAX package: its host layer is its own."""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = """
import sys
import numpy as np
import sblas_torch
from sblas_torch import datasets, golden

a = datasets.banded(64, 3, seed=0)
x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
plan = sblas_torch.SpmvPlan(a, device="cpu")
y = plan(x).numpy()
assert plan.method == "csr", plan.method
assert golden.rel_err(y, golden.spmv_golden(a, x)) < 2e-5
X = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
Y = sblas_torch.spmm(a, X, k_hint=8, device="cpu").numpy()
assert golden.rel_err(Y, golden.spmm_golden(a, X)) < 2e-5
bad = [m for m in sys.modules
       if m in ("jax", "triton", "sblas") or m.startswith(("jax.", "sblas."))]
print("LEAKED", bad)
"""


def test_import_and_spmv_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_host_layer_is_the_ports_own():
    import sblas
    import sblas_torch

    assert sblas_torch.CSR is not sblas.CSR
    assert sblas_torch.CSC is not sblas.CSC
    assert sblas_torch.CSR.__module__ == "sblas_torch.formats"
    for mod in ("datasets", "golden", "retile", "retile_bsr"):
        assert getattr(sblas_torch, mod).__name__ == f"sblas_torch.{mod}"
    assert sblas_torch.golden.spmv_golden is not sblas.golden.spmv_golden
    assert sblas_torch.read_mtx.__module__ == "sblas_torch.io"


def test_lazy_entry_points():
    import sblas_torch
    from sblas_torch.ops import spmm as spmm_mod
    from sblas_torch.ops import spmv as spmv_mod

    assert sblas_torch.spmv is spmv_mod.spmv
    assert sblas_torch.SpmvPlan is spmv_mod.SpmvPlan
    assert sblas_torch.spmm is spmm_mod.spmm
    assert sblas_torch.SpmmPlan is spmm_mod.SpmmPlan


def test_default_device_and_probe():
    import pytest
    from sblas_torch.utils.backend import default_device, probe

    cuda = torch.cuda.is_available()
    if cuda:
        assert default_device().type == "cuda"
    else:
        # the card is the default; the CPU only when a caller asks for it
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_device()
    p = probe()
    assert p["cuda"] is cuda
    assert p["torch"] == torch.__version__
    assert p["torch_cuda"] == torch.version.cuda
    if not cuda:
        assert p["device"] is None and p["sm_count"] is None
    for key in ("nvcc", "nvidia_smi"):
        assert p[key] is None or isinstance(p[key], str)
