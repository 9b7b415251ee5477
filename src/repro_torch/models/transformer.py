"""Decoder stacks for all assigned families (dense/moe/ssm/hybrid/vlm/audio).

Parameters keep the reference's pytree: the same dict keys, with each
layer's leaves stacked on a leading ``[L, …]`` axis (the hybrid stack's
``[n_sites, attn_every, …]``), so weights carry across leaf for leaf.
:func:`run_stack` loops over the layers in Python, indexing the stacked
leaves. The hybrid (zamba2-style) stack is ``n_sites`` super-blocks
(attn_every mamba layers + one *shared* attention block) plus trailing
mamba layers, so the shared block's KV cache is per-site, not per-layer.

Caches are updated in place: a cache passed to :func:`run_stack` is
consumed and returned.

Without a cache (training) the layer loop is rematerialized as the
reference's ``jax.checkpoint`` over its ``lax.scan`` body
(``cfg.remat``): each layer runs under ``torch.utils.checkpoint``, and
with ``cfg.nested_remat`` the layers go in √L groups, each group
checkpointed as a whole too. Values do not change; memory does.

:func:`run_stack_tp` is the training path split over a client's ranks
(:mod:`repro_torch.models.tp`): ``_dense_layer_tp`` and
``_shared_block_tp`` run attention and MLP (or the MoE experts) on every
rank's shards, the norms, residual adds and mamba blocks once on rank 0's
device. The remat wraps the same layer bodies, cross-device sums included.
Given a cache site they are the serving split's layers too
(:mod:`repro_torch.models.serve_split`).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm
from repro_torch.models.attention import run_attention, run_attention_tp
from repro_torch.models.layers import dense_init, embed_init, rms_norm, swiglu
from repro_torch.models.moe import moe_ffn

Params = Any


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of a dict tree (same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _at(tree, i: int):
    """Layer i of a stacked tree (of each rank's tree, for a list)."""
    if isinstance(tree, list):
        return [_at(t, i) for t in tree]
    return tree_map(lambda a: a[i], tree)


def _device(device: DeviceLike) -> torch.device:
    """``"meta"`` as given (shapes only); else the card unless asked."""
    return (torch.device("meta") if str(device) == "meta"
            else resolve_device(device))


# ---------------------------------------------------------------------------
# Per-layer init (``lead`` stacks layers on leading axes)
# ---------------------------------------------------------------------------

def _attn_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, hq, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    p = {
        "wq": dense_init(gen, d, hq * dh, dtype, device, lead),
        "wk": dense_init(gen, d, hkv * dh, dtype, device, lead),
        "wv": dense_init(gen, d, hkv * dh, dtype, device, lead),
        "wo": dense_init(gen, hq * dh, d, dtype, device, lead),
    }
    if cfg.attn_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=device)
    return p


def _mlp_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, d, f, dtype, device, lead)
    p["w_up"] = dense_init(gen, d, f, dtype, device, lead)
    p["w_down"] = dense_init(gen, f, d, dtype, device, lead)
    return p


def _mlp_apply(cfg: ModelConfig, params, x):
    if cfg.mlp_type == "swiglu":
        return swiglu(x, params["w_gate"], params["w_up"], params["w_down"])
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


def _mlp_apply_tp(cfg: ModelConfig, ps: list, x, tp):
    """The MLP split by ``d_ff``: column-parallel ``w_gate/w_up``,
    row-parallel ``w_down`` summed over the ranks (whole on rank 0's
    device where ``d_ff`` does not divide)."""
    from repro_torch.models.tp import check_shape
    f_ok, f = tp.split(cfg.d_ff)
    if not f_ok:
        return _mlp_apply(cfg, ps[0], x)
    xs = tp.scatter(x)
    for p in ps:
        check_shape(p["w_up"], (cfg.d_model, f), "w_up")
    return tp.reduce([_mlp_apply(cfg, p, xm) for p, xm in zip(ps, xs)])


def _moe_apply_tp(cfg: ModelConfig, ps: list, x, tp):
    """The MoE FFN with the router and its dispatch once on rank 0's
    device and the experts split by ``d_ff`` (``w_down`` row-parallel,
    summed over the ranks)."""
    from repro_torch.models.moe import expert_ffn
    from repro_torch.models.tp import check_shape
    f_ok, f = tp.split(cfg.d_ff)
    experts = None
    if f_ok:
        for p in ps:
            check_shape(p["w_up"], (cfg.num_experts, cfg.d_model, f),
                        "w_up")

        def experts(hin):
            hs = tp.scatter(hin)
            return tp.reduce([expert_ffn(p, h) for p, h in zip(ps, hs)])
    return moe_ffn(ps[0], x, num_experts=cfg.num_experts,
                   top_k=cfg.num_experts_per_tok,
                   capacity_factor=cfg.capacity_factor, experts=experts)


def _moe_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(gen, d, e, torch.float32, device, lead),
        "w_gate": dense_init(gen, d, f, dtype, device, (*lead, e)),
        "w_up": dense_init(gen, d, f, dtype, device, (*lead, e)),
        "w_down": dense_init(gen, f, d, dtype, device, (*lead, e)),
    }


def _dense_layer_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    ones = dict(dtype=dtype, device=device)
    return {
        "attn": _attn_init(gen, cfg, dtype, device, lead),
        "mlp": (_moe_init(gen, cfg, dtype, device, lead)
                if cfg.family == "moe"
                else _mlp_init(gen, cfg, dtype, device, lead)),
        "ln1": torch.ones((*lead, cfg.d_model), **ones),
        "ln2": torch.ones((*lead, cfg.d_model), **ones),
    }


def _mamba_layer_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    return {
        "mamba": ssm.mamba2_init(gen, cfg, dtype, device, lead),
        "ln": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# Per-layer apply
# ---------------------------------------------------------------------------

def _dense_layer(cfg: ModelConfig, params, h, cache=None, pos=None,
                 fracs: bool = False):
    """Pre-LN transformer layer; returns (h, cache, aux) — with ``fracs``,
    an MoE layer's ``[frac_tokens, frac_probs]`` in place of its aux."""
    x = rms_norm(h, params["ln1"], cfg.norm_eps)
    o, cache = run_attention(
        params["attn"], x, cfg_heads=cfg.num_heads, cfg_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window, cache=cache, pos=pos)
    h = h + o
    x = rms_norm(h, params["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux, *fr = moe_ffn(params["mlp"], x, num_experts=cfg.num_experts,
                              top_k=cfg.num_experts_per_tok,
                              capacity_factor=cfg.capacity_factor,
                              with_fracs=fracs)
        aux = fr[0] if fracs else aux
    else:
        y = _mlp_apply(cfg, params["mlp"], x)
        aux = None
    return h + y, cache, aux


def _attention_tp(cfg: ModelConfig, ps: list, x, tp, cache=None):
    return run_attention_tp(
        ps, x, tp, cfg_heads=cfg.num_heads, cfg_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window, cache=cache)


def _attn_residual_tp(cfg: ModelConfig, ps: list, h, tp, cache=None):
    """``h`` + the pre-LN attention sub-layer over ``tp``'s ranks (with a
    serving cache site, :func:`run_attention_tp`'s)."""
    x = rms_norm(h, ps[0]["ln1"], cfg.norm_eps)
    return h + _attention_tp(cfg, [p["attn"] for p in ps], x, tp, cache)


def _dense_layer_tp(cfg: ModelConfig, ps: list, h, tp, cache=None):
    """:func:`_dense_layer` over ``tp``'s ranks (``ps[m]`` rank m's layer
    tree; ``cache`` a serving split's cache site); returns (h, aux)."""
    h = _attn_residual_tp(cfg, ps, h, tp, cache)
    x = rms_norm(h, ps[0]["ln2"], cfg.norm_eps)
    mlps = [p["mlp"] for p in ps]
    if cfg.family == "moe":
        y, aux = _moe_apply_tp(cfg, mlps, x, tp)
    else:
        y, aux = _mlp_apply_tp(cfg, mlps, x, tp), None
    return h + y, aux


def _mamba_layer(cfg: ModelConfig, params, h, cache=None):
    x = rms_norm(h, params["ln"], cfg.norm_eps)
    y, cache = ssm.mamba2_block(params["mamba"], cfg, x, cache)
    return h + y, cache


def _shared_block(cfg: ModelConfig, params, h, cache=None, pos=None):
    """Zamba2-style shared transformer block (attn + MLP)."""
    x = rms_norm(h, params["ln1"], cfg.norm_eps)
    o, cache = run_attention(
        params["attn"], x, cfg_heads=cfg.num_heads, cfg_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window, cache=cache, pos=pos)
    h = h + o
    x = rms_norm(h, params["ln2"], cfg.norm_eps)
    return h + _mlp_apply(cfg, params["mlp"], x), cache


def _shared_block_tp(cfg: ModelConfig, ps: list, h, tp, cache=None):
    """:func:`_shared_block` over ``tp``'s ranks (``cache`` as
    :func:`_dense_layer_tp`'s)."""
    h = _attn_residual_tp(cfg, ps, h, tp, cache)
    x = rms_norm(h, ps[0]["ln2"], cfg.norm_eps)
    return h + _mlp_apply_tp(cfg, [p["mlp"] for p in ps], x, tp)


# ---------------------------------------------------------------------------
# Stack init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device: DeviceLike = None) -> Params:
    """Random params in the reference's tree, shapes, dtypes and scales
    (dense √(2/(din+dout)), embed 0.02, ``conv_w`` 0.2, f32 router and
    ``dt_bias``/``a_log``/``d_skip``). Normals are drawn in float32 from
    ``generator`` on its own device and moved to ``device`` (the card
    unless asked for another; ``"meta"`` gives shapes only)."""
    dev = _device(device)
    dtype, gen = cfg.dtype, generator
    params: dict = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                       dtype, dev)
    L = cfg.num_layers
    if cfg.family == "ssm":
        params["layers"] = _mamba_layer_init(gen, cfg, dtype, dev, (L,))
    elif cfg.family == "hybrid":
        n_sites = L // cfg.attn_every
        trailing = L - n_sites * cfg.attn_every
        params["layers"] = _mamba_layer_init(gen, cfg, dtype, dev,
                                             (n_sites, cfg.attn_every))
        if trailing:
            params["trailing"] = _mamba_layer_init(gen, cfg, dtype, dev,
                                                   (trailing,))
        ones = dict(dtype=dtype, device=dev)
        params["shared_attn"] = {
            "attn": _attn_init(gen, cfg, dtype, dev),
            "mlp": _mlp_init(gen, cfg, dtype, dev),
            "ln1": torch.ones((cfg.d_model,), **ones),
            "ln2": torch.ones((cfg.d_model,), **ones),
        }
    else:  # dense / moe / vlm / audio share the dense-stack structure
        params["layers"] = _dense_layer_init(gen, cfg, dtype, dev, (L,))
    return params


def param_specs(cfg: ModelConfig) -> Params:
    """The params tree on the ``meta`` device: shapes and dtypes, no
    allocation (the reference's ``jax.eval_shape`` of ``init_params``)."""
    return init_params(cfg, None, "meta")


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Any:
    """Zeroed decode caches, stacked per layer as the reference's (real
    zeros: decode writes each layer's slice in place)."""
    dev = _device(device)
    dtype = cfg.dtype
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    # SWA needs only the last `window` tokens → ring buffer (attention.py)
    eff_len = (min(max_len, cfg.sliding_window) if cfg.sliding_window > 0
               else max_len)

    def attn_cache(lead):
        shape = (*lead, batch, eff_len, hkv, dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    if cfg.family == "ssm":
        return {"layers": ssm.mamba2_cache_init(cfg, batch, dtype, dev,
                                                (cfg.num_layers,))}
    if cfg.family == "hybrid":
        n_sites = cfg.num_layers // cfg.attn_every
        trailing = cfg.num_layers - n_sites * cfg.attn_every
        cache = {
            "layers": ssm.mamba2_cache_init(cfg, batch, dtype, dev,
                                            (n_sites, cfg.attn_every)),
            "shared": attn_cache((n_sites,)),
        }
        if trailing:
            cache["trailing"] = ssm.mamba2_cache_init(cfg, batch, dtype, dev,
                                                      (trailing,))
        return cache
    return {"layers": attn_cache((cfg.num_layers,))}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The cache tree on the ``meta`` device (the reference's
    ``jax.eval_shape`` of ``init_cache``)."""
    return init_cache(cfg, batch, max_len, "meta")


# ---------------------------------------------------------------------------
# Stack apply
# ---------------------------------------------------------------------------

def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat`` is set
    and autograd records (a plain call otherwise)."""
    if not cfg.remat:
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return wrapped


def _remat_groups(cfg: ModelConfig, num_layers: int) -> int:
    """Largest divisor of L that is ≤ ⌈√L⌉ (√L checkpointing group count)."""
    if not (cfg.remat and cfg.nested_remat) or num_layers < 4:
        return 1
    cap = math.isqrt(num_layers - 1) + 1
    best = 1
    for g in range(2, cap + 1):
        if num_layers % g == 0:
            best = g
    return best


def _scan_layers(cfg: ModelConfig, body, carry, stacked):
    """Loop ``carry = body(carry, layer_params)`` over stacked layer params
    with the optional √L nested remat (the no-cache training path, where
    only the carry matters)."""
    first = stacked[0] if isinstance(stacked, list) else stacked
    num_layers = tree_leaves(first)[0].shape[0]
    g = _remat_groups(cfg, num_layers)
    layer = _maybe_remat(lambda c, i: body(c, _at(stacked, i)), cfg)

    def run(c, lo: int, hi: int):
        for i in range(lo, hi):
            c = layer(c, i)
        return c

    if g == 1:
        return run(carry, 0, num_layers)
    per = num_layers // g
    group = _maybe_remat(lambda c, j: run(c, j * per, (j + 1) * per), cfg)
    for j in range(g):
        carry = group(carry, j)
    return carry


def run_stack(cfg: ModelConfig, params, h: torch.Tensor, cache=None,
              pos: Optional[int] = None, fracs: bool = False):
    """h: [B, S, D] embeddings → (h, cache, aux). ``cache`` (updated in
    place) and ``pos`` (a Python int) for prefill/decode. ``fracs`` (an MoE
    training forward) gives each layer's ``[frac_tokens, frac_probs]``,
    ``[L, 2, E]``, in place of the summed aux."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    if fracs:
        if cfg.family != "moe" or cache is not None:
            raise ValueError("fracs: an MoE stack's training forward")

        def fr_body(carry, p_i):
            hh, fr = carry
            hh, _, f = _dense_layer(cfg, p_i, hh, fracs=True)
            return hh, torch.cat([fr, f[None]])
        h, fr = _scan_layers(
            cfg, fr_body, (h, torch.zeros((0, 2, cfg.num_experts),
                                          device=h.device)),
            params["layers"])
        return h, None, fr

    if cfg.family == "ssm":
        if cache is None:
            h = _scan_layers(
                cfg, lambda hh, p_i: _mamba_layer(cfg, p_i, hh, None)[0],
                h, params["layers"])
            return h, None, aux_total
        for i in range(cfg.num_layers):
            c_i = None if cache is None else _at(cache["layers"], i)
            h, _ = _mamba_layer(cfg, _at(params["layers"], i), h, c_i)
        return h, cache, aux_total

    if cfg.family == "hybrid":
        n_sites = cfg.num_layers // cfg.attn_every
        trailing = cfg.num_layers - n_sites * cfg.attn_every
        mamba = _maybe_remat(
            lambda hh, p_j: _mamba_layer(cfg, p_j, hh, None)[0], cfg)
        for site in range(n_sites):
            for j in range(cfg.attn_every):
                p_j = _at(_at(params["layers"], site), j)
                if cache is None:
                    h = mamba(h, p_j)
                    continue
                h, _ = _mamba_layer(cfg, p_j, h,
                                    _at(_at(cache["layers"], site), j))
            sh = None if cache is None else _at(cache["shared"], site)
            h, _ = _shared_block(cfg, params["shared_attn"], h, sh, pos)
        for i in range(trailing):
            p_i = _at(params["trailing"], i)
            if cache is None:
                h = mamba(h, p_i)
                continue
            h, _ = _mamba_layer(cfg, p_i, h, _at(cache["trailing"], i))
        return h, cache, aux_total

    # dense / moe / vlm / audio
    if cache is None:
        def body(carry, p_i):
            hh, aux = carry
            hh, _, a = _dense_layer(cfg, p_i, hh, None, None)
            return (hh, aux if a is None else aux + a)
        h, aux_total = _scan_layers(cfg, body, (h, aux_total),
                                    params["layers"])
        return h, None, aux_total
    for i in range(cfg.num_layers):
        c_i = None if cache is None else _at(cache["layers"], i)
        h, _, a = _dense_layer(cfg, _at(params["layers"], i), h, c_i, pos)
        if a is not None:
            aux_total = aux_total + a
    return h, cache, aux_total


def run_stack_tp(cfg: ModelConfig, ranks: list, h: torch.Tensor, tp):
    """:func:`run_stack`'s training path (no cache) over ``tp``'s ranks:
    ``ranks[m]`` is rank m's param tree, ``h`` the embeddings on rank 0's
    device → (h, aux) there. The mamba blocks (their leaves are
    replicated) run once on rank 0's device."""
    p0 = ranks[0]
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)

    def mamba_body(hh, p_j):
        return _mamba_layer(cfg, p_j, hh, None)[0]
    if cfg.family == "ssm":
        return _scan_layers(cfg, mamba_body, h, p0["layers"]), aux_total
    if cfg.family == "hybrid":
        n_sites = cfg.num_layers // cfg.attn_every
        trailing = cfg.num_layers - n_sites * cfg.attn_every
        mamba = _maybe_remat(mamba_body, cfg)
        shared = [r["shared_attn"] for r in ranks]
        for site in range(n_sites):
            for j in range(cfg.attn_every):
                h = mamba(h, _at(_at(p0["layers"], site), j))
            h = _shared_block_tp(cfg, shared, h, tp)
        for i in range(trailing):
            h = mamba(h, _at(p0["trailing"], i))
        return h, aux_total

    def body(carry, p_is):
        hh, aux = carry
        hh, a = _dense_layer_tp(cfg, p_is, hh, tp)
        return (hh, aux if a is None else aux + a)
    return _scan_layers(cfg, body, (h, aux_total),
                        [r["layers"] for r in ranks])
