"""Fault-tolerant checkpointing (port of :mod:`repro.checkpoint`): atomic,
keep-N GC, in the reference's on-disk format.

* a checkpoint is a directory ``step_<n>/`` holding ``leaves.npz`` (one
  array ``a<i>`` per leaf) plus a JSON manifest (key paths, shapes,
  dtypes, step);
* writes go to ``step_<n>.tmp/`` then ``os.replace`` → readers never see a
  partial checkpoint (atomicity on POSIX rename);
* ``keep_n`` oldest checkpoints are garbage-collected after a successful
  commit (never before);
* error-feedback / TCS state are ordinary fields — they ride along.

Leaves are walked in ``jax.tree`` order — NamedTuple fields in order
(path ``.name``), dict keys sorted, tuple entries by index, ``None``
skipped — and bfloat16 is stored as float32 (npz has no bfloat16), so a
checkpoint written by either package restores into the other. A state
placed by rank is written in the same global layout (each
:class:`~repro_torch.train.state.RankPieces` and
:class:`~repro_torch.train.state.RankShards` gathered whole on the CPU)
and restored onto its ranks' devices by ``restore(..., mesh=, specs=)``:
the params and ``tcs_prev`` by their ``param_pspecs``, the flat leaves by
rank.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.state import RankPieces, RankShards

_NP_SAVABLE = {"float64", "float32", "float16", "int64", "int32", "int16",
               "int8", "uint8", "uint16", "uint32", "uint64", "bool"}


def _numpy(x) -> np.ndarray:
    if isinstance(x, RankPieces):
        x = x.gather("cpu")
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x)


def _savable(arr: np.ndarray) -> np.ndarray:
    """npz can't serialize bfloat16/f8; upcast losslessly to f32 —
    restore() casts back to the template's dtype."""
    if arr.dtype.name in _NP_SAVABLE:
        return arr
    return arr.astype(np.float32)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree: Any, prefix: tuple = ()):
    """→ [(path parts, leaf)] in the reference's order (a
    :class:`RankPieces` is one leaf, a :class:`RankShards` its whole tree,
    gathered on the CPU, or on ``meta`` for an abstract one)."""
    if tree is None:
        return []
    if isinstance(tree, RankShards):
        first = _flatten_with_paths(tree.trees[0])[0][1]
        return _flatten_with_paths(
            tree.gather("meta" if first.is_meta else "cpu"), prefix)
    if isinstance(tree, RankPieces):
        return [(prefix, tree)]
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += _flatten_with_paths(getattr(tree, name),
                                       prefix + ("." + name,))
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def _unflatten(template: Any, it) -> Any:
    if template is None:
        return None
    if isinstance(template, RankShards):
        return _unflatten(template.trees[0], it)
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, n), it)
                                for n in template._fields))
    if isinstance(template, dict):
        return {k: _unflatten(template[k], it) for k in sorted(template)}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, it) for v in template)
    return next(it)


def save(ckpt_dir: str, step: int, state: Any, *, keep_n: int = 3) -> str:
    """Atomically write ``state`` under ``ckpt_dir/step_<step>``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten_with_paths(state)
    paths = ["/".join(p) for p, _ in flat]
    arrays = {f"a{i}": _savable(_numpy(leaf))
              for i, (_, leaf) in enumerate(flat)}
    np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": [list(np.shape(a)) for a in arrays.values()],
        "dtypes": [str(np.asarray(a).dtype) for a in arrays.values()],
        "num_leaves": len(flat),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic commit

    # GC after commit
    ckpts = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for old in ckpts[:-keep_n] if keep_n > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, old))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, *, step: Optional[int] = None,
            device=None, mesh=None, specs=None) -> Any:
    """Restore into the structure of ``template`` (validates leaf count).

    Each leaf takes the template leaf's dtype and lands on ``device``, or
    on the template leaf's device when none is given (a ``meta`` template
    needs ``device``). With ``mesh`` and ``specs`` (the reference's
    ``shardings=``: :func:`~repro_torch.train.step.state_shardings` of the
    mesh) the template is a train state, whole or placed, and the restored
    state is placed on ``mesh`` as
    :func:`~repro_torch.train.step.init_state` places it: each rank's
    piece lands on its rank's device from the CPU.
    """
    if (mesh is None) != (specs is None):
        raise ValueError("restore takes mesh= and specs= together")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(d, "leaves.npz"))
    leaves = [data[f"a{i}"] for i in range(manifest["num_leaves"])]

    t_leaves = [leaf for _, leaf in _flatten_with_paths(template)]
    if len(t_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template expects "
            f"{len(t_leaves)} — incompatible TrainConfig?")
    if mesh is None and any(isinstance(t, RankPieces) for t in t_leaves):
        raise ValueError("a placed template needs mesh= and specs=")
    out = []
    for tl, arr in zip(t_leaves, leaves):
        if mesh is not None:
            dev = torch.device("cpu")
        else:
            dev = tl.device if device is None else torch.device(device)
        if dev.type == "meta":
            raise ValueError("a meta template needs device=")
        out.append(torch.as_tensor(np.array(arr)).to(device=dev,
                                                     dtype=tl.dtype))
    tree = _unflatten(template, iter(out))
    if mesh is None:
        return tree
    from repro_torch.train.step import place_state
    return place_state(tree, mesh, specs)
