"""Learning-rate schedules (port of ``repro/optim/schedule.py``): pure
functions of the step counter, an integer tensor, computed in f32."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, end_frac: float = 0.1):
    step = step.float()
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (end_frac + (1 - end_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_):
    return torch.full_like(step, peak_lr, dtype=torch.float32)


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant}
