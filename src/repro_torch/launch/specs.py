"""input_specs(): shape-and-dtype stand-ins for every dry-run cell (port
of :mod:`repro.launch.specs`).

Each leaf is an empty tensor on the ``meta`` device (the reference's
``jax.ShapeDtypeStruct``): no allocation. The shapes come from the per-arch
shape sets (``configs/base.py`` ``SHAPES``). Token ids are int32, as in the
reference.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models import model as model_mod


def S(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": S((b, s), torch.int32),
        "labels": S((b, s), torch.int32),
    }
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = S((b, s, cfg.d_model), cfg.dtype)
        batch["frontend_mask"] = S((b, s), torch.bool)
    elif cfg.frontend == "audio":
        batch["frontend_embeds"] = S((b, s, cfg.d_model), cfg.dtype)
    return batch


def prefill_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    out = {
        "tokens": S((b, s), torch.int32),
        "cache": model_mod.cache_specs(cfg, b, s),
    }
    if cfg.frontend == "vision":
        out["extra"] = {
            "frontend_embeds": S((b, s, cfg.d_model), cfg.dtype),
            "frontend_mask": S((b, s), torch.bool),
        }
    elif cfg.frontend == "audio":
        out["extra"] = {"frontend_embeds": S((b, s, cfg.d_model), cfg.dtype)}
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """One new token against a KV cache of seq_len (the decode_* / long_*
    cells)."""
    b, s = shape.global_batch, shape.seq_len
    return {
        "token": S((b,), torch.int32),
        "pos": S((), torch.int32),
        "cache": model_mod.cache_specs(cfg, b, s),
    }


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return decode_specs(cfg, shape)
