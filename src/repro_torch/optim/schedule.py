"""Learning-rate schedules as functions of the step (port of
``repro/optim/schedule.py``), computed in float32 as JAX's are: the step
may be an int or a 0-dim tensor (on the device, so the train step reads
nothing back), and the result is a 0-dim float32 tensor."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def linear_warmup(step, peak_lr: float, warmup_steps: int) -> torch.Tensor:
    s = _f32(step)
    return peak_lr * torch.clamp_max((s + 1.0) / max(warmup_steps, 1), 1.0)


def cosine_schedule(step, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    s = _f32(step)
    warm = linear_warmup(s, peak_lr, warmup_steps)
    prog = torch.clamp((s - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(s < warmup_steps, warm, peak_lr * cos)
