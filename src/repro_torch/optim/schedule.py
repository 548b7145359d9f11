"""Learning-rate schedules (scale factors multiplying ``AdamWConfig.lr``)
— the port of ``repro.optim.schedule``, in float32 as XLA compiles the
JAX functions inside the jitted train step: a division by a constant is
a multiplication by its float32 reciprocal, and the cosine's last
multiply-add is one fused multiply-add (``adamw.fma``).  The cosine
itself is torch's, which may differ from XLA's in the last bit.

``step`` is an int or a tensor; the result is a float32 tensor on the
step's device (the CPU for an int), so a schedule evaluated on a step
counter that lives on the card costs no copy (its constants are fills
on the card, which a captured train step can hold).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.optim.adamw import fma


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.full((), np.float32(step), dtype=torch.float32)


def _over(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``: ``x`` times float32(1 / c)."""
    return x * float(np.float32(1.0 / c))


def linear_warmup(step, warmup_steps: int) -> torch.Tensor:
    step = _f32(step)
    return torch.clamp_max(_over(step + 1.0, max(1.0, float(warmup_steps))), 1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to final_frac of peak."""
    step = _f32(step)
    warm = linear_warmup(step, warmup_steps)
    progress = torch.clamp(
        _over(step - warmup_steps, max(1.0, float(total_steps - warmup_steps))), 0.0, 1.0)
    wave = 1.0 + torch.cos(progress * float(np.float32(math.pi)))
    half = torch.full((), np.float32((1.0 - final_frac) * 0.5), dtype=torch.float32,
                      device=wave.device)
    cos = fma(wave, half, torch.full_like(wave, final_frac))
    return torch.where(step < warmup_steps, warm, cos)
