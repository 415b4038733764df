"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def is_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain path), False
    when every one lies on one CUDA device (the kernel path); raises for
    anything else — a mix, or another device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError("kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device, got {[str(t.device) for t in tensors]}")


def check_f32(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
