"""Learning-rate schedules (port of ``repro/optim/schedules.py``): each
maps the step, a () int tensor, to the rate, a () fp32 tensor on its
device."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def sched(step):
        t = torch.clamp(step.to(torch.float32), max=decay_steps) / decay_steps
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * ((1 - alpha) * cos + alpha)

    return sched


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  alpha: float = 0.0):
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), alpha)

    def sched(step):
        s = step.to(torch.float32)
        warm = lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(step - warmup_steps))

    return sched
