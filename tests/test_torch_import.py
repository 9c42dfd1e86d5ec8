"""The port imports on CPU-only torch, without JAX, nvcc or triton."""

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
bad = [m for m in ("jax", "triton", "sblas.ops", "sblas.utils")
       if m in sys.modules]
print("LEAKED", bad)
"""


def test_import_and_spmv_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_host_layer_is_reused():
    import sblas
    import sblas_torch

    assert sblas_torch.CSR is sblas.CSR and sblas_torch.CSC is sblas.CSC
    assert sblas_torch.datasets is sblas.datasets
    # the goldens themselves; sblas_torch.golden adds the port's limits
    for name in ("spmv_golden", "rel_err", "default_tol"):
        assert getattr(sblas_torch.golden, name) is getattr(sblas.golden, name)


def test_lazy_entry_points():
    import sblas_torch
    from sblas_torch.ops import spmv as spmv_mod

    assert sblas_torch.spmv is spmv_mod.spmv
    assert sblas_torch.SpmvPlan is spmv_mod.SpmvPlan


def test_default_device_and_probe():
    from sblas_torch.utils.backend import default_device, probe

    cuda = torch.cuda.is_available()
    assert default_device().type == ("cuda" if cuda else "cpu")
    p = probe()
    assert p["cuda"] is cuda
    assert p["torch"] == torch.__version__
    assert p["torch_cuda"] == torch.version.cuda
    if not cuda:
        assert p["device"] is None and p["sm_count"] is None
    for key in ("nvcc", "nvidia_smi"):
        assert p[key] is None or isinstance(p[key], str)
