"""Device resolution, the float32 precision switches and a toolchain probe."""

from __future__ import annotations

import shutil
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card. The CPU only where the caller names it
    (``device="cpu"``); a CUDA device with no GPU raises, it never silently
    becomes the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def set_full_fp32() -> None:
    """Full-precision float32 matmuls and convolutions: the EM's solves and
    trace updates need it (the JAX package forces "highest" precision for
    the same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def nvcc_path() -> str | None:
    """``nvcc`` on the PATH, else the CUDA toolkit's default location."""
    return shutil.which("nvcc") or shutil.which("nvcc", path="/usr/local/cuda/bin")


def toolchain_probe() -> dict:
    """What the build can use, for the record only (nothing branches on it)."""
    out = {"torch": torch.__version__, "torch_cuda": torch.version.cuda}
    nvcc = nvcc_path()
    if nvcc is None:
        out["nvcc"] = None
    else:
        res = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
        out["nvcc"] = lines[-1] if lines else res.stdout
    try:
        import triton  # noqa: F401

        out["triton"] = triton.__version__
    except ImportError:
        out["triton"] = None
    out["cuda_available"] = torch.cuda.is_available()
    if out["cuda_available"]:
        out["device_name"] = torch.cuda.get_device_name(0)
    return out
