"""Modality-frontend stubs (backbone-only for [vlm]/[audio]).

The transformer BACKBONE of internvl2-26b and musicgen-medium is modelled;
the modality frontends (InternViT-6B / EnCodec) are represented by
*precomputed* embeddings:

* vision: ``frontend_embeds [B, S, D]`` + ``frontend_mask [B, S]`` — mask
  marks image-patch positions whose embeddings come from the (stub) ViT;
  text positions keep their token embeddings.
* audio: ``frontend_embeds [B, S, D]`` added to EnCodec-token embeddings
  (conditioning path). MusicGen's 4-codebook delay-pattern heads are
  collapsed to the single vocab-2048 head.

The stub embeddings are drawn from a ``torch.Generator`` (float32 normals
on the generator's device, moved to ``device``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import normal


def vision_stub_embeds(cfg: ModelConfig, generator: torch.Generator,
                       batch: int, seq: int, num_patches: int,
                       device: DeviceLike = None):
    """Deterministic fake patch embeddings occupying the first positions."""
    dev = resolve_device(device)
    fe = normal(generator, (batch, seq, cfg.d_model), dev) * 0.02
    mask = ((torch.arange(seq, device=dev)[None, :] < num_patches)
            & torch.ones((batch, 1), dtype=torch.bool, device=dev))
    return fe.to(cfg.dtype).to(dev), mask


def audio_stub_embeds(cfg: ModelConfig, generator: torch.Generator,
                      batch: int, seq: int, device: DeviceLike = None):
    """Deterministic fake conditioning-frame embeddings (added to tokens)."""
    dev = resolve_device(device)
    fe = normal(generator, (batch, seq, cfg.d_model), dev) * 0.02
    return fe.to(cfg.dtype).to(dev)
