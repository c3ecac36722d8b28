"""Learning-rate schedules (pure functions of the step) — the twin of
``repro/optim/schedules.py``, in f32 on the step's device."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, total_steps: int, final_frac: float = 0.1):
    t = torch.clamp(torch.as_tensor(step).to(torch.float32)
                    / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return final_frac + (1.0 - final_frac) * cos


def linear_warmup_cosine(step, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup, 1)
    rest = cosine_schedule(torch.clamp(s - warmup, min=0.0),
                           max(total_steps - warmup, 1), final_frac)
    return torch.where(s < warmup, warm, rest)
