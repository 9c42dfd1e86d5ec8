"""Device selection and a toolchain probe for the port.

Every plan takes an explicit ``device=``; :func:`default_device` is what it
gets when the caller gives none: the card, never the CPU by surprise.
:func:`probe` reports what a run needs to
know about the machine: the card, the CUDA version torch was built for, the
``nvcc`` that builds the kernels, and the card's power limit (an H100 may be
set below its 700 W, and then runs slower under load).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

import torch


def default_device() -> torch.device:
    """``cuda``. Raises ``RuntimeError`` where torch sees no card: the CPU
    runs the kernels' plain versions only when a caller asks for it with
    ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch sees no CUDA device; pass device='cpu' to run the "
            "kernels' plain torch versions on the CPU")
    return torch.device("cuda")


def pick_device(name: str | None) -> torch.device:
    """The device a command line names: ``cpu``, or the card (``cuda``,
    the default), which :func:`default_device` checks is there."""
    return torch.device("cpu") if name == "cpu" else default_device()


def find_nvcc() -> str | None:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``). None when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    return str(cand) if cand.is_file() and os.access(cand, os.X_OK) else None


def nvidia_smi() -> str | None:
    """``name, power.limit`` of the cards as nvidia-smi prints them, or None
    where nvidia-smi is missing or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def probe() -> dict:
    """What this process can run on: CUDA present, the card and its SM
    count, ``torch.version.cuda``, the ``nvcc`` path and nvidia-smi's
    ``name, power.limit`` (None where absent)."""
    cuda = torch.cuda.is_available()
    props = torch.cuda.get_device_properties(0) if cuda else None
    return {
        "cuda": cuda,
        "device": props.name if props else None,
        "sm_count": props.multi_processor_count if props else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": find_nvcc(),
        "nvidia_smi": nvidia_smi(),
    }
