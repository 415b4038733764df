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


def check_f32(name: str, t: torch.Tensor, shape: tuple,
              dtypes=(torch.float32,)) -> None:
    """``t`` has ``shape``, one of ``dtypes`` (float32 alone unless the
    kernel reads more) and is contiguous; raises otherwise."""
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name}: expected {names}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_ptr(t: torch.Tensor) -> int:
    """``t``'s device's current stream.  The plain C library launches on
    the CUDA runtime's current device, so every launch also runs under
    ``torch.cuda.device(t.device)``: a shard on another card than the
    current one would otherwise get a stream of the wrong device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_shards(mesh, **shards) -> None:
    """Each named argument of a sharded kernel is a sequence of one
    tensor per shard of ``mesh``, shard i's on ``mesh.devices[i]``."""
    for name, parts in shards.items():
        if len(parts) != mesh.size:
            raise ValueError(f"{name}: expected {mesh.size} shards, got "
                             f"{len(parts)}")
        for i, (t, dev) in enumerate(zip(parts, mesh.devices, strict=True)):
            if t.device.type != dev.type or (
                    dev.index is not None and t.device.index != dev.index):
                raise ValueError(f"{name}: shard {i} lies on {t.device}, "
                                 f"the mesh puts it on {dev}")



def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def refuse_grad(name: str, *operands,
                detail: str = "its inputs must not require grad") -> None:
    """Raise ``ValueError`` when any operand (a tensor, or a dict, list
    or tuple of them, nested) requires grad.  No kernel has a backward,
    and the kernel path builds no autograd node: a differentiable caller
    takes the plain version by name.  Every wrapper calls this first, so
    the CPU path refuses what the card's would."""
    if any(t.requires_grad for x in operands for t in _tensors(x)):
        raise ValueError(f"{name} has no backward: {detail}")
