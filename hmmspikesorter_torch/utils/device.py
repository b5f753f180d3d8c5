"""Device resolution and platform report: which device an entry point runs
on and what this host offers the port (the card's budgets are
utils/platform.py's).

Entry points run on CUDA unless the caller asks for the CPU. There is no
fallback: with no GPU and no explicit `device="cpu"`, `resolve_device`
raises. The working dtype follows the device: float32 on CUDA (the kernels'
type) and float64 on the CPU (the f64 oracle, mirroring JAX x64 on CPU).
"""

from __future__ import annotations

import importlib.util
import os
import shutil

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; raises when CUDA was asked for and is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    return torch.float32 if device.type == "cuda" else torch.float64


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch float dtype."""
    return {torch.float32: np.dtype(np.float32),
            torch.float64: np.dtype(np.float64)}[dtype]


def as_float(x, dtype, device) -> torch.Tensor:
    """x as a `dtype` tensor on `device`. Host values go through float64
    first, so a Python float never passes through torch's float32 default
    on its way to float64."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return x.to(device=device, dtype=dtype)


def nvcc_path() -> str | None:
    """The CUDA compiler, from PATH or the toolkit's usual home."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")          # the toolkit's default prefix
    return cand if os.path.exists(cand) else None


def platform_report() -> dict:
    """What this host offers the port: torch, CUDA, nvcc, triton."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "nvcc": nvcc_path(),
        "triton": importlib.util.find_spec("triton") is not None,
    }
