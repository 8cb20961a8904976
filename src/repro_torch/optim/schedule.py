"""LR schedules (the port of ``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(
    step, base_lr: float, warmup_steps: int, total_steps: int,
    min_ratio: float = 0.1,
) -> torch.Tensor:
    """Linear warm-up to ``base_lr``, then a cosine decay to ``min_ratio``
    of it, in f32.  ``step`` may be a tensor (the optimizer's step, on the
    device: no host read) or a number; the result is an f32 scalar tensor
    on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * (step + 1) / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
