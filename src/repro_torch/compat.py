"""Host and toolchain facts for the port (twin of ``repro/compat.py``).

The port has two engine backends: ``reference`` (the plain PyTorch
oracle in ``kernels/ref.py``, runnable anywhere) and ``cuda`` (the
hand-written Hopper kernels, built with ``nvcc`` for ``sm_90a`` at first
use). ``default_device()`` is the card; there is no silent fall back to
the CPU.
"""
from __future__ import annotations

import shutil
import subprocess

import torch

HOPPER = (9, 0)


def platform() -> str:
    """The host's accelerator platform: "gpu" or "cpu"."""
    return "gpu" if torch.cuda.is_available() else "cpu"


def is_hopper(device=None) -> bool:
    """Whether a CUDA device of compute capability 9.0 is present."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(device) == HOPPER)


def available_backends() -> tuple[str, ...]:
    """Engine backends runnable on THIS host, oracle first."""
    out = ["reference"]
    if is_hopper():
        out.append("cuda")
    return tuple(out)


def default_device() -> torch.device:
    """The CUDA card every entry point runs on unless told otherwise."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is present "
            "(torch.cuda.is_available() is False); pass device='cpu' "
            "explicitly to run the plain PyTorch versions on the host")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else as given."""
    return default_device() if device is None else torch.device(device)


def nvcc_path() -> str | None:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if shutil.which(default) else None


def nvidia_smi() -> str | None:
    """``name, power.limit`` of the cards as nvidia-smi reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    res = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return res.stdout.strip() if res.returncode == 0 else None


def probe() -> dict:
    """Versions, the device and the toolchain, for the record."""
    out = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_name": None,
        "capability": None,
        "device_count": torch.cuda.device_count(),
        "nvcc": nvcc_path(),
        "nvidia_smi": nvidia_smi(),
        "backends": list(available_backends()),
    }
    if torch.cuda.is_available():
        out["device_name"] = torch.cuda.get_device_name(0)
        out["capability"] = list(torch.cuda.get_device_capability(0))
    return out
