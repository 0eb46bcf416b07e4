"""LR schedules (port of ``repro.optim.schedule``): pure functions of the
step tensor, so the rate stays on the device."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor_frac · peak_lr`` at ``total``; a float32 tensor on the
    step's device (the reference's arithmetic, in its order)."""
    s = step.float()
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
