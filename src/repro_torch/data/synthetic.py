"""Deterministic synthetic data (port of :mod:`repro.data.synthetic`):
an MNIST-like image set and a bigram language model.

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


# ---------------------------------------------------------------------------
# Synthetic language-model data (a bigram Markov chain)
# ---------------------------------------------------------------------------

class BigramLM(NamedTuple):
    trans: Tensor   # [V, V] row-wise transition logits


def make_bigram_lm(seed, vocab: int, *, concentration: float = 3.0,
                   device: DeviceLike = None) -> BigramLM:
    """Random sparse-ish bigram transition table, fixed by ``seed`` (an
    int, drawn on ``device`` — the card unless asked — or a
    ``torch.Generator``, drawn on its device and moved to ``device``);
    the reference's ``jax.random`` bits are not reproduced — a parity test
    passes the reference's realized ``trans`` as ``BigramLM(trans=...)``.
    """
    dev = resolve_device(device)
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    logits = torch.randn((vocab, vocab), generator=gen,
                         dtype=torch.float32, device=gen.device)
    return BigramLM(trans=(logits * concentration).to(dev))


def sample_bigram(lm: BigramLM, generator: torch.Generator, batch: int,
                  seq: int) -> Tensor:
    """Sample token sequences ``[B, S+1]`` (int64) from the bigram chain,
    on ``lm.trans``'s device; ``generator`` must live there too."""
    v = lm.trans.shape[0]
    dev = lm.trans.device
    tok = torch.randint(0, v, (batch,), generator=generator, device=dev)
    out = [tok]
    for _ in range(seq):
        # one row per sequence: a [V, V] softmax would double the table
        probs = torch.softmax(lm.trans[tok], dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        out.append(tok)
    return torch.stack(out, dim=1)


def lm_batch(lm: BigramLM, generator: torch.Generator, batch: int,
             seq: int) -> dict:
    """``{"tokens": x[:, :-1], "labels": x[:, 1:]}`` of one sampled
    ``[B, S+1]`` chain."""
    toks = sample_bigram(lm, generator, batch, seq)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
