"""Model facade: embeddings + stack + head, loss, prefill/decode entrypoints.

A cache passed to :func:`prefill` or :func:`decode_step` is consumed
(updated in place) and returned.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import rms_norm

MOE_AUX_WEIGHT = 0.01


def embed_inputs(cfg: ModelConfig, params, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None,
                 frontend_mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings, with the modality-stub injection points.

    vision (internvl2): positions where ``frontend_mask`` is set take the
    precomputed patch embeddings instead of the token embedding.
    audio (musicgen): precomputed frame/conditioning embeddings are *added*
    to the EnCodec-token embeddings.
    """
    h = params["embed"][tokens]
    if frontend_embeds is not None:
        fe = frontend_embeds.to(h.dtype)
        if cfg.frontend == "vision":
            assert frontend_mask is not None
            h = torch.where(frontend_mask[..., None], fe, h)
        elif cfg.frontend == "audio":
            h = h + fe
        else:
            raise ValueError(f"{cfg.name} has no frontend but got embeds")
    return h


def lm_logits(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    """Project to the (padded) vocabulary; pad slots masked to −1e30."""
    if cfg.tie_embeddings:
        logits = h @ params["embed"].T
    else:
        logits = h @ params["lm_head"]
    if cfg.padded_vocab > cfg.vocab_size:
        pad_mask = (torch.arange(cfg.padded_vocab, device=h.device)
                    < cfg.vocab_size)
        logits = torch.where(pad_mask, logits, -1e30)
    return logits


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            frontend_embeds=None, frontend_mask=None):
    """Teacher-forcing forward. tokens [B, S] → (logits [B, S, V], aux)."""
    h = embed_inputs(cfg, params, tokens, frontend_embeds, frontend_mask)
    h, _, aux = transformer.run_stack(cfg, params, h)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, h), aux


def loss_fn(cfg: ModelConfig, params, batch: dict):
    """Mean next-token cross-entropy (f32) + MoE aux. batch: tokens, labels.
    The forward value only (the train step's gradient is not ported)."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("frontend_embeds"),
                          batch.get("frontend_mask"))
    logp = torch.log_softmax(logits.float(), dim=-1)
    # labels may be int32, as the reference's input specs give them
    ll = torch.take_along_dim(logp, batch["labels"][..., None].long(),
                              dim=-1)
    ce = -torch.mean(ll)
    total = ce + MOE_AUX_WEIGHT * aux
    return total, {"ce": ce, "aux": aux}


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache,
            frontend_embeds=None, frontend_mask=None):
    """Process a full prompt, seeding the cache.

    → (last_logits [B,V], cache).
    """
    h = embed_inputs(cfg, params, tokens, frontend_embeds, frontend_mask)
    h, cache, _ = transformer.run_stack(cfg, params, h, cache=cache)
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, h)[:, 0], cache


def decode_step(cfg: ModelConfig, params, cache, token: torch.Tensor,
                pos: int):
    """One decode step. token [B] int, ``pos`` a Python int (the host knows
    it) → (logits [B,V], cache)."""
    h = params["embed"][token][:, None, :]               # [B, 1, D]
    h, cache, _ = transformer.run_stack(cfg, params, h, cache=cache,
                                        pos=int(pos))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, h)[:, 0], cache


init_params = transformer.init_params
param_specs = transformer.param_specs
init_cache = transformer.init_cache
cache_specs = transformer.cache_specs
