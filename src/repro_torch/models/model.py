"""Model facade: embeddings + stack + head, loss, prefill/decode entrypoints.

A cache passed to :func:`prefill` or :func:`decode_step` is consumed
(updated in place) and returned. :func:`loss_fn_tp` is the loss split
over a client's ranks (:mod:`repro_torch.models.tp`): a vocab-parallel
embedding and cross-entropy around :func:`~repro_torch.models.transformer.
run_stack_tp`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import to_device
from repro_torch.models import transformer
from repro_torch.models.layers import rms_norm
from repro_torch.models.tp import check_shape

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
    return _frontend(cfg, params["embed"][tokens], frontend_embeds,
                     frontend_mask)


def _frontend(cfg: ModelConfig, h: torch.Tensor, frontend_embeds,
              frontend_mask) -> torch.Tensor:
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
    ce = _cross_entropy(logits, batch["labels"])
    total = ce + MOE_AUX_WEIGHT * aux
    return total, {"ce": ce, "aux": aux}


def loss_parts(cfg: ModelConfig, params, batch: dict):
    """An MoE's loss in parts, for a client whose batch runs in pieces →
    (mean cross-entropy f32, ``[L, 2, E]`` each layer's ``[frac_tokens,
    frac_probs]``): the whole batch's loss is the pieces' mean
    cross-entropy + ``MOE_AUX_WEIGHT`` · :func:`moe_aux` of their mean
    fractions."""
    h = embed_inputs(cfg, params, batch["tokens"],
                     batch.get("frontend_embeds"), batch.get("frontend_mask"))
    h, _, fr = transformer.run_stack(cfg, params, h, fracs=True)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _cross_entropy(lm_logits(cfg, params, h), batch["labels"]), fr


def moe_aux(cfg: ModelConfig, fracs: torch.Tensor) -> torch.Tensor:
    """Σ over layers (in layer order, f32) of each layer's load-balancing
    loss from its ``[frac_tokens, frac_probs]`` (``fracs [L, 2, E]``)."""
    from repro_torch.models.moe import aux_of
    total = torch.zeros((), dtype=torch.float32, device=fracs.device)
    for f in fracs:
        total = total + aux_of(f[0], f[1], cfg.num_experts)
    return total


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    # labels may be int32, as the reference's input specs give them
    ll = torch.take_along_dim(logp, labels[..., None].long(), dim=-1)
    return -torch.mean(ll)


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


# ---------------------------------------------------------------------------
# Tensor-parallel training form (repro_torch.models.tp)
# ---------------------------------------------------------------------------

def _vocab_range(tp, cfg: ModelConfig, m: int) -> tuple:
    width = cfg.padded_vocab // tp.m
    return m * width, width


def _local_ids(ids: torch.Tensor, lo: int, width: int, device) -> tuple:
    """Token ids on ``device`` → (their index into the vocab range
    ``[lo, lo + width)``, clamped; whether the range holds them)."""
    local = to_device(ids, device).long() - lo
    own = (local >= 0) & (local < width)
    return local.clamp(0, width - 1), own


def embed_inputs_tp(cfg: ModelConfig, ranks: list, tokens: torch.Tensor,
                    tp, frontend_embeds=None, frontend_mask=None
                    ) -> torch.Tensor:
    """:func:`embed_inputs` with a vocab-parallel ``embed``: rank m looks
    up the tokens of its vocab range (zero rows elsewhere), the rows are
    summed over the ranks on rank 0's device, and the frontend acts on the
    sum there. Whole there where the vocabulary does not divide."""
    if not tp.split(cfg.padded_vocab)[0]:
        return embed_inputs(cfg, ranks[0], to_device(tokens, tp.home),
                            frontend_embeds, frontend_mask)
    parts = []
    for m, (r, dev) in enumerate(zip(ranks, tp.devices)):
        lo, width = _vocab_range(tp, cfg, m)
        table = check_shape(r["embed"], (width, cfg.d_model), "embed")
        local, own = _local_ids(tokens, lo, width, dev)
        parts.append(torch.where(own[..., None], table[local], 0))
    return _frontend(cfg, tp.reduce(parts), frontend_embeds, frontend_mask)


def _logits_shard(cfg: ModelConfig, r, h: torch.Tensor, lo: int,
                  width: int) -> torch.Tensor:
    """Rank m's logits over its vocab range ``[lo, lo + width)`` (the
    tied ``embed`` shardᵀ or the ``lm_head`` shard), pad slots −1e30."""
    if cfg.tie_embeddings:
        logits = h @ check_shape(r["embed"], (width, cfg.d_model),
                                 "embed").T
    else:
        logits = h @ check_shape(r["lm_head"], (cfg.d_model, width),
                                 "lm_head")
    if lo + width > cfg.vocab_size:
        real = lo + torch.arange(width, device=h.device) < cfg.vocab_size
        logits = torch.where(real, logits, -1e30)
    return logits


def _cross_entropy_tp(cfg: ModelConfig, ranks: list, h: torch.Tensor,
                      labels: torch.Tensor, tp) -> torch.Tensor:
    """Mean next-token cross-entropy (f32) with vocab-parallel logits:
    each rank's shard stays on its device; the max (a shift, no gradient),
    Σ exp and the label's logit are each reduced over the ranks."""
    hs = tp.scatter(h)
    logits, labs = [], []
    for m, (r, hm) in enumerate(zip(ranks, hs)):
        lo, width = _vocab_range(tp, cfg, m)
        logits.append(_logits_shard(cfg, r, hm, lo, width).float())
        local, own = _local_ids(labels, lo, width, hm.device)
        lab = torch.take_along_dim(logits[-1], local[..., None], dim=-1)
        labs.append(torch.where(own, lab[..., 0], 0))
    top = tp.max([x.amax(-1) for x in logits])
    sumexp = tp.reduce([
        torch.sum(torch.exp(x - to_device(top, x.device)[..., None]), -1)
        for x in logits])
    ll = (tp.reduce(labs) - top) - torch.log(sumexp)
    return -torch.mean(ll)


def loss_fn_tp(cfg: ModelConfig, ranks: list, batch: dict, tp):
    """:func:`loss_fn` over ``tp``'s ranks: ``ranks[m]`` is rank m's param
    tree (its shard of each model-sharded leaf, the replicated leaves
    whole), ``batch`` one client's inputs → (loss, aux dict) on rank 0's
    device, with autograd across the ranks' devices."""
    fe = batch.get("frontend_embeds")
    fm = batch.get("frontend_mask")
    h = embed_inputs_tp(cfg, ranks, batch["tokens"], tp,
                        None if fe is None else to_device(fe, tp.home),
                        None if fm is None else to_device(fm, tp.home))
    h, aux = transformer.run_stack_tp(cfg, ranks, h, tp)
    h = rms_norm(h, ranks[0]["final_norm"], cfg.norm_eps)
    if tp.split(cfg.padded_vocab)[0]:
        ce = _cross_entropy_tp(cfg, ranks, h, batch["labels"], tp)
    else:
        ce = _cross_entropy(lm_logits(cfg, ranks[0], h),
                            to_device(batch["labels"], tp.home))
    total = ce + MOE_AUX_WEIGHT * aux
    return total, {"ce": ce, "aux": aux}


init_params = transformer.init_params
param_specs = transformer.param_specs
init_cache = transformer.init_cache
cache_specs = transformer.cache_specs
