"""Device selection for the port's entry points.

Every entry point takes ``device=``.  Left at ``None`` it means the
CUDA device, and where none is visible the call raises: the port never
carries on silently on the CPU.  ``device="cpu"`` is an explicit request
for the plain PyTorch path (what the CPU tests use).
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device; raises when no CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless device='cpu' is "
            "passed, and torch.cuda.is_available() is False here")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` → :func:`default_device`; anything else → torch.device."""
    return default_device() if device is None else torch.device(device)


def fp32_products(device: torch.device) -> None:
    """On CUDA, switch TF32 off for cuBLAS matrix products and cuDNN
    convolutions, so a solve's products run in full fp32 as the
    reference's do on the CPU (cuDNN's default is TF32, ~1e-3 off), and
    make cuDNN pick deterministic algorithms: its default ones for the
    CNN's grouped convolutions give another round on each call (two
    calls of the ragged CIFAR round from one state differed on an
    H100), and the port's runs must repeat bit for bit (a sweep against
    its runs alone, a resumed run against the uninterrupted one, the
    host backend against the device backend)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
