"""Optimizers (port of :mod:`repro.optim.optimizers`), implemented twice:

* flat-space — operates on the ``[D_pad]`` flattened master params (fp32;
  ZeRO-1 in the reference, where each rank updates its own segment). The
  update is elementwise, so updating the whole vector at once gives each
  segment's values;
* pytree — convenience for the FL simulator / examples.

The reference runs under ``jax.jit``, which contracts ``a·b + c`` into one
FMA: the moment updates and the parameter step are written as
:func:`torch.addcmul` (one rounding), as the rest of the port does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.transformer import tree_leaves, tree_map

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # sgd | momentum | adamw
    lr: float = 1e-3
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0           # 0 = off; global-norm clip


class FlatOptState(NamedTuple):
    step: Tensor                     # int32 scalar
    m: Optional[Tensor]              # [D] or None (sgd)
    v: Optional[Tensor]              # [D] or None (sgd/momentum)


def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def init_flat(cfg: OptConfig, d: int, like: Optional[Tensor] = None,
              device=None) -> FlatOptState:
    """Zero moments ``[d]`` on ``like``'s device (else ``device``, else the
    CPU: the caller names the device of a flat state it builds from
    scratch)."""
    dev = like.device if like is not None else device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.name == "sgd":
        return FlatOptState(step, None, None)
    zeros = (torch.zeros((d,), dtype=torch.float32, device=dev)
             if like is None else torch.zeros_like(like, dtype=torch.float32))
    if cfg.name == "momentum":
        return FlatOptState(step, zeros, None)
    if cfg.name == "adamw":
        return FlatOptState(step, zeros, torch.zeros_like(zeros))
    raise ValueError(cfg.name)


def _clip_scale(cfg: OptConfig, sq_sum: Tensor) -> Tensor:
    gn = torch.sqrt(sq_sum)
    return torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)


def _adam_moments(cfg: OptConfig, m, v, g):
    # m = b1·m + (1−b1)·g and v = b2·v + (1−b2)·g·g, one rounding each
    m = torch.addcmul((1 - cfg.b1) * g, m, _f32(cfg.b1).to(g.device))
    v = torch.addcmul((1 - cfg.b2) * g * g, v, _f32(cfg.b2).to(g.device))
    return m, v


def _adam_update(cfg: OptConfig, p, m, v, t):
    c1 = 1 - torch.pow(_f32(cfg.b1).to(t.device), t)
    vh = v / (1 - torch.pow(_f32(cfg.b2).to(t.device), t))
    # (m / c1) / den: XLA folds the two divisions into m / (c1 · den)
    u = m / (c1 * (torch.sqrt(vh) + cfg.eps))
    if cfg.weight_decay:
        u = torch.addcmul(u, p, _f32(cfg.weight_decay).to(p.device))
    return u


def apply_flat(cfg: OptConfig, state: FlatOptState, params: Tensor,
               grad: Tensor, lr_scale=1.0, sq_sum=None) -> tuple:
    """One elementwise update in flat fp32 space → (params, state).

    ``sq_sum``: the whole gradient's Σ g² for ``grad_clip`` when ``grad``
    is one piece of it (default: ``grad``'s own)."""
    g = grad.to(torch.float32)
    p = params.to(torch.float32)
    if cfg.grad_clip > 0:
        g = g * _clip_scale(cfg, torch.sum(g * g) if sq_sum is None
                            else sq_sum.to(g.device))
    step = state.step + 1
    lr = (cfg.lr * _f32(lr_scale)).to(p.device)
    if cfg.name == "sgd":
        return (torch.addcmul(p, -lr, g),
                FlatOptState(step, None, None))
    if cfg.name == "momentum":
        m = torch.addcmul(g, state.m, _f32(cfg.momentum).to(g.device))
        return torch.addcmul(p, -lr, m), FlatOptState(step, m, None)
    if cfg.name == "adamw":
        m, v = _adam_moments(cfg, state.m, state.v, g)
        upd = _adam_update(cfg, p, m, v, step.to(torch.float32))
        return torch.addcmul(p, -lr, upd), FlatOptState(step, m, v)
    raise ValueError(cfg.name)


# ---------------------------------------------------------------------------
# Pytree variants (simulator / examples)
# ---------------------------------------------------------------------------

class TreeOptState(NamedTuple):
    step: Tensor
    m: Any
    v: Any


def init_tree(cfg: OptConfig, params: Any) -> TreeOptState:
    leaf = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)

    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    if cfg.name == "sgd":
        return TreeOptState(step, None, None)
    if cfg.name == "momentum":
        return TreeOptState(step, zeros(), None)
    return TreeOptState(step, zeros(), zeros())


def _tree_map2(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map2(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def apply_tree(cfg: OptConfig, state: TreeOptState, params: Any, grads: Any,
               lr_scale=1.0) -> tuple:
    """One update of a dict tree; params keep their dtypes."""
    if cfg.grad_clip > 0:
        sq = None
        for g in tree_leaves(grads):
            s = torch.sum(torch.square(g.to(torch.float32)))
            sq = s if sq is None else sq + s
        scale = _clip_scale(cfg, sq)
        grads = tree_map(lambda g: g * scale, grads)
    step = state.step + 1
    leaf = tree_leaves(params)[0]
    lr = (cfg.lr * _f32(lr_scale)).to(leaf.device)
    if cfg.name == "sgd":
        new_p = _tree_map2(
            lambda p, g: torch.addcmul(p.to(torch.float32), -lr,
                                       g.to(torch.float32)).to(p.dtype),
            params, grads)
        return new_p, TreeOptState(step, None, None)
    if cfg.name == "momentum":
        m = _tree_map2(lambda mm, g: torch.addcmul(
            g.to(torch.float32), mm, _f32(cfg.momentum).to(mm.device)),
            state.m, grads)
        new_p = _tree_map2(
            lambda p, mm: torch.addcmul(p.to(torch.float32), -lr,
                                        mm).to(p.dtype), params, m)
        return new_p, TreeOptState(step, m, None)
    t = step.to(torch.float32)
    mv = _tree_map2(lambda mm, vv, g: _adam_moments(
        cfg, mm, vv, g.to(torch.float32)), state.m, state.v, grads)
    m, v = _pick(mv, 0), _pick(mv, 1)

    def upd(p, mm, vv):
        pf = p.to(torch.float32)
        return torch.addcmul(pf, -lr, _adam_update(cfg, pf, mm, vv, t)
                             ).to(p.dtype)

    new_p = _tree_map2(upd, params, m, v)
    return new_p, TreeOptState(step, m, v)


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
