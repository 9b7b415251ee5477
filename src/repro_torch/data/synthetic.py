"""Deterministic synthetic MNIST-like data (port of
:mod:`repro.data.synthetic`'s ``make_synthetic_mnist``).

A 10-class, 784-dim image-like dataset with MNIST's dimensionality, so the
paper's d = 7850 logistic regression runs at its real width. Classes are
smooth random templates (7×7 noise upsampled bilinearly to 28×28) plus
per-sample noise and a per-sample intensity scale; linear separability is
partial. The structure is the reference's; the numbers are drawn with
numpy from the seed, so they differ from the JAX package's draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class Dataset(NamedTuple):
    x: Tensor     # [N, 784] float32
    y: Tensor     # [N] int64


def _templates(rng: np.random.Generator, num_classes: int,
               dim: int) -> np.ndarray:
    """Smooth class templates: low-frequency random images of norm 6."""
    side = int(dim ** 0.5)
    coarse = torch.from_numpy(rng.standard_normal((num_classes, 1, 7, 7)))
    up = torch.nn.functional.interpolate(coarse, size=(side, side),
                                         mode="bilinear", align_corners=False)
    t = up.reshape(num_classes, dim).numpy()
    t = t / np.linalg.norm(t, axis=1, keepdims=True) * 6.0
    return t + 0.1 * rng.standard_normal((num_classes, dim))


def make_synthetic_mnist(seed: int, n: int, *, num_classes: int = 10,
                         dim: int = 784, noise: float = 1.0,
                         template_seed: int = 42,
                         device: DeviceLike = None) -> Dataset:
    """``seed`` draws the samples; the class templates are dataset-level
    constants fixed by ``template_seed`` (train and test share them)."""
    dev = resolve_device(device)
    t = _templates(np.random.default_rng(template_seed), num_classes, dim)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n)
    x = t[y] + noise * rng.standard_normal((n, dim))
    x = x * (0.7 + 0.6 * rng.random((n, 1)))
    return Dataset(x=torch.as_tensor(x, dtype=torch.float32, device=dev),
                   y=torch.as_tensor(y, dtype=torch.int64, device=dev))
