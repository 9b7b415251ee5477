"""Sharding rules: partition specs for params, caches and batches (port of
:mod:`repro.models.partition`).

A spec is a plain tuple with one entry per dimension: an axis name, a tuple
of axis names, or ``None`` (the reference's ``PartitionSpec``). Rules are
divisibility-aware (DESIGN §5): a dim is sharded over the ``model`` axis
only when it divides evenly AND the sharding is head-aligned where heads
matter; otherwise the leaf stays replicated over ``model``. Batch shards
over (``pod``, ``data``); long-context decode (batch 1) shards the
KV-cache sequence dim over ``data`` (split-K decode).

The port has no GSPMD: these specs are data. The flat layout
(:mod:`repro_torch.core.flat_layout`) reads them to decide which leaves a
model column slices and which it replicates; :func:`shard` takes rank m's
piece of a leaf by its spec and :func:`rank_params` rank m's whole tree
(:mod:`repro_torch.models.tp` computes on those trees;
:class:`~repro_torch.train.state.RankShards` gathers them back).
"""

from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ModelConfig


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def batch_axes(mesh) -> tuple:
    """Mesh axes used for data parallelism ((pod, data) when present)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _model_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def _stack(spec, extra_lead: int = 1):
    if isinstance(spec, dict):
        return {k: _stack(v, extra_lead) for k, v in spec.items()}
    return (None,) * extra_lead + tuple(spec)


def param_pspecs(cfg: ModelConfig, mesh) -> Any:
    """Spec tree matching ``transformer.init_params`` output."""
    m = _model_size(mesh)
    hq, hkv = cfg.num_heads, cfg.num_kv_heads

    def attn_specs():
        # head-aligned TP: shard projections only if the head count divides
        q_ok = _div(hq, m)
        kv_ok = _div(hkv, m)
        s = {
            "wq": (None, "model") if q_ok else (None, None),
            "wk": (None, "model") if kv_ok else (None, None),
            "wv": (None, "model") if kv_ok else (None, None),
            "wo": ("model", None) if q_ok else (None, None),
        }
        if cfg.attn_bias:
            s["bq"] = ("model",) if q_ok else (None,)
            s["bk"] = ("model",) if kv_ok else (None,)
            s["bv"] = ("model",) if kv_ok else (None,)
        return s

    def mlp_specs():
        f_ok = _div(cfg.d_ff, m)
        s = {
            "w_up": (None, "model") if f_ok else (None, None),
            "w_down": ("model", None) if f_ok else (None, None),
        }
        if cfg.mlp_type == "swiglu":
            s["w_gate"] = s["w_up"]
        return s

    def moe_specs():
        f_ok = _div(cfg.d_ff, m)
        return {
            "router": (None, None),
            "w_gate": (None, None, "model") if f_ok else (None, None, None),
            "w_up": (None, None, "model") if f_ok else (None, None, None),
            "w_down": (None, "model", None) if f_ok else (None, None, None),
        }

    def mamba_specs():
        # mixed-group in_proj concat dim → replicated over model (DESIGN §5)
        return {
            "in_proj": (None, None), "conv_w": (None, None),
            "dt_bias": (None,), "a_log": (None,), "d_skip": (None,),
            "norm": (None,), "out_proj": (None, None),
        }

    v_ok = _div(cfg.padded_vocab, m)
    specs: dict = {
        "embed": ("model", None) if v_ok else (None, None),
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "model") if v_ok else (None, None)

    if cfg.family == "ssm":
        specs["layers"] = _stack({"mamba": mamba_specs(), "ln": (None,)})
    elif cfg.family == "hybrid":
        specs["layers"] = _stack({"mamba": mamba_specs(), "ln": (None,)},
                                 extra_lead=2)
        trailing = cfg.num_layers % cfg.attn_every
        if trailing:
            specs["trailing"] = _stack({"mamba": mamba_specs(),
                                        "ln": (None,)})
        specs["shared_attn"] = {
            "attn": attn_specs(), "mlp": mlp_specs(),
            "ln1": (None,), "ln2": (None,),
        }
    else:
        layer = {
            "attn": attn_specs(),
            "mlp": moe_specs() if cfg.family == "moe" else mlp_specs(),
            "ln1": (None,), "ln2": (None,),
        }
        specs["layers"] = _stack(layer)
    return specs


def model_dim(spec, shape, m_size: int) -> Any:
    """The dimension of a leaf of ``shape`` that ``spec`` shards over a
    ``model`` axis of ``m_size`` (``None`` where the leaf is replicated: no
    ``model`` entry, or a dimension that the axis does not divide — the
    flat layout's rule)."""
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names:
            return None if shape[i] % m_size else i
    return None


def shard(x, spec, m: int, m_size: int):
    """Rank m's piece of the leaf ``x`` under ``spec`` over a ``model``
    axis of ``m_size``: a view of block m along its model dimension, or
    ``x`` itself where the leaf is replicated."""
    dim = model_dim(spec, tuple(x.shape), m_size)
    if dim is None or m_size == 1:
        return x
    width = x.shape[dim] // m_size
    return x.narrow(dim, m * width, width)


def rank_params(params, specs, m: int, m_size: int):
    """Rank m's param tree: :func:`shard` of every leaf (views)."""
    if isinstance(params, dict):
        return {k: rank_params(params[k], specs[k], m, m_size)
                for k in params}
    return shard(params, specs, m, m_size)


def batch_pspecs(cfg: ModelConfig, mesh, global_batch: int) -> Any:
    """Specs for {tokens, labels, frontend_*} train/prefill inputs."""
    dp = batch_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    b_spec = dp if _div(global_batch, dp_size) else None
    out = {"tokens": (b_spec, None), "labels": (b_spec, None)}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = (b_spec, None, None)
        out["frontend_mask"] = (b_spec, None)
    elif cfg.frontend == "audio":
        out["frontend_embeds"] = (b_spec, None, None)
    return out


def cache_pspecs(cfg: ModelConfig, mesh, global_batch: int) -> Any:
    """Specs for the decode cache. Batch shards over (pod, data) when it
    divides; otherwise (long_500k, batch 1) the *sequence* dim shards over
    data (split-K decode) and SSM states replicate over data."""
    m = _model_size(mesh)
    dp = batch_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    b_ok = _div(global_batch, dp_size)
    kv_ok = _div(cfg.num_kv_heads, m)
    # long-context (batch 1): cache seq shards over `data` (split-K
    # decode). Non-divisible KV heads: cache seq shards over `model`
    # instead of replicating a 32k-deep cache per device.
    seq_axis = None if b_ok else "data"
    if b_ok and not kv_ok:
        seq_axis = "model"

    # leaves carry 1 or 2 leading stacking dims (layers / sites×layers)
    def attn_kv(lead):
        return ((None,) * lead + (dp if b_ok else None, seq_axis,
                                  "model" if kv_ok else None, None))

    def conv(lead):
        return (None,) * lead + (dp if b_ok else None, None, None)

    def state(lead):
        return (None,) * lead + (dp if b_ok else None, None, None, None)

    if cfg.family == "ssm":
        return {"layers": {"conv": conv(1), "state": state(1)}}
    if cfg.family == "hybrid":
        out = {
            "layers": {"conv": conv(2), "state": state(2)},
            "shared": {"k": attn_kv(1), "v": attn_kv(1)},
        }
        if cfg.num_layers % cfg.attn_every:
            out["trailing"] = {"conv": conv(1), "state": state(1)}
        return out
    return {"layers": {"k": attn_kv(1), "v": attn_kv(1)}}
