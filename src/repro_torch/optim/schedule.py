"""Learning-rate schedules (port of :mod:`repro.optim.schedule`; scale
factors multiplied onto ``OptConfig.lr``).

Written as jitted XLA computes the reference: a division by a constant is
a product with its float32 reciprocal, and ``a·b + c`` one FMA
(:func:`torch.addcmul`).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _recip(n: int) -> float:
    return float(np.float32(1) / np.float32(max(n, 1)))


def lr_schedule(step, *, warmup: int = 100, decay_steps: int = 10_000,
                kind: str = "cosine", min_ratio: float = 0.1):
    """Warmup-then-decay scale in [min_ratio, 1], as a float32 0-d tensor
    (on ``step``'s device when ``step`` is a tensor)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    s = torch.as_tensor(step, device=dev).to(torch.float32)
    warm = torch.clamp((s + 1) * _recip(warmup), max=1.0)
    if kind == "constant":
        return warm
    frac = torch.clamp((s - warmup) * _recip(decay_steps - warmup), 0.0, 1.0)

    def const(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    if kind == "cosine":
        half = float(np.float32(1 - min_ratio) * np.float32(0.5))
        decay = torch.addcmul(const(min_ratio), const(half),
                              1 + torch.cos(math.pi * frac))
    elif kind == "linear":
        decay = torch.addcmul(const(1.0), const(-(1 - min_ratio)), frac)
    else:
        raise ValueError(kind)
    return warm * decay
