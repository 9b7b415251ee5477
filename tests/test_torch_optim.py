"""The port's optimizers and schedule (``repro_torch.optim``) against the
reference's under ``jax.jit``.

Reference twin: ``tests/test_optim.py``. The same numpy parameters and
gradients go through jitted ``repro.optim.apply_flat`` / ``apply_tree``
and the port, six steps under a warmup-cosine ``lr_schedule``:

* bit for bit: SGD, momentum, and AdamW with weight decay — XLA contracts
  ``b·m + g``, ``(1−b)·g + b·m``, ``p − lr·u`` and ``u + wd·p`` into FMAs
  (``torch.addcmul``) and folds ``(m / c₁) / den`` into ``m / (c₁·den)``;
  and ``lr_schedule``'s linear and constant forms (divisions by
  constants are products with the float32 reciprocal);
* to 1e-6 relative (of each element and of the vector's largest
  magnitude, so a moment that cancels to near zero is held in scale):
  AdamW without weight decay (the jitted update differs in
  the last bit on about 1 element in 4,000 from the second step on; no
  torch expression probed reproduces it) and every ``grad_clip`` case
  (the global norm is a sum whose order is XLA's);
* the cosine schedule to rtol 1e-6: XLA's float32 ``cos`` differs from
  ``torch.cos`` in the last bit on about 5 % of arguments;
* ``b ** t`` as the jitted reference computes it differs from
  ``torch.pow`` on a few t (first at t = 6 for b = 0.95): the first steps
  of a run are bitwise, later ones within the tolerance above.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as ro
from repro.optim import schedule as rs
from repro_torch.optim import (FlatOptState, OptConfig, apply_flat,
                               apply_tree, init_flat, init_tree, lr_schedule)

torch.set_num_threads(1)

D = 4099
STEPS = 6
RTOL = 1e-6


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _bitwise(name, clip, wd):
    return clip == 0 and (name != "adamw" or wd > 0)


def _data():
    rng = np.random.default_rng(0)
    p = rng.standard_normal(D).astype(np.float32)
    gs = [(rng.standard_normal(D) * 0.1 * (1 + s)).astype(np.float32)
          for s in range(STEPS)]
    return p, gs


def _check(got, want, exact, what):
    if exact:
        assert np.array_equal(_bits(got), _bits(want)), (
            what, int(np.sum(_bits(got) != _bits(want))))
    else:
        np.testing.assert_allclose(
            got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
            err_msg=what)


@pytest.mark.parametrize("name,clip,wd", list(itertools.product(
    ["sgd", "momentum", "adamw"], [0.0, 1.0], [0.0, 0.01])))
def test_apply_flat_equals_the_reference(name, clip, wd):
    rcfg = ro.OptConfig(name=name, lr=1e-3, grad_clip=clip, weight_decay=wd)
    cfg = OptConfig(name=name, lr=1e-3, grad_clip=clip, weight_decay=wd)
    p, gs = _data()
    rst, rp = ro.init_flat(rcfg, D), jnp.asarray(p)
    st, tp = init_flat(cfg, D, device="cpu"), torch.as_tensor(p)
    f = jax.jit(lambda s, pp, gg, ls: ro.apply_flat(rcfg, s, pp, gg, ls))
    sched = jax.jit(lambda s: rs.lr_schedule(s, warmup=3, decay_steps=10))
    exact = _bitwise(name, clip, wd)
    for s, g in enumerate(gs):
        ls = sched(jnp.int32(s))
        lt = lr_schedule(torch.tensor(s, dtype=torch.int32), warmup=3,
                         decay_steps=10)
        assert np.array_equal(_bits(ls), _bits(lt.numpy()))
        rp, rst = f(rst, rp, jnp.asarray(g), ls)
        tp, st = apply_flat(cfg, st, tp, torch.as_tensor(g), lt)
        assert int(st.step) == int(rst.step) == s + 1
        _check(tp.numpy(), np.asarray(rp), exact, f"{name} step {s} params")
        for field in ("m", "v"):
            a, b = getattr(st, field), getattr(rst, field)
            assert (a is None) == (b is None), field
            if a is not None:
                _check(a.numpy(), np.asarray(b), clip == 0,
                       f"{name} step {s} {field}")


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_apply_tree_equals_the_reference(name):
    rcfg = ro.OptConfig(name=name, lr=0.01, weight_decay=0.1)
    cfg = OptConfig(name=name, lr=0.01, weight_decay=0.1)
    p, gs = _data()
    tree = {"a": p[:100].reshape(10, 10), "b": p[100:]}
    rt, rst = jax.tree.map(jnp.asarray, tree), ro.init_tree(rcfg, tree)
    tt = {k: torch.as_tensor(v) for k, v in tree.items()}
    st = init_tree(cfg, tt)
    f = jax.jit(lambda s, pp, gg: ro.apply_tree(rcfg, s, pp, gg))
    for g in gs[:3]:
        gt = {"a": g[:100].reshape(10, 10), "b": g[100:]}
        rt, rst = f(rst, rt, jax.tree.map(jnp.asarray, gt))
        tt, st = apply_tree(cfg, st, tt,
                            {k: torch.as_tensor(v) for k, v in gt.items()})
        for k in tree:
            _check(tt[k].numpy(), np.asarray(rt[k]), name != "adamw",
                   f"{name} {k}")


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup,decay", [(7, 50), (100, 10_000)])
def test_lr_schedule_equals_the_reference(kind, warmup, decay):
    f = jax.jit(lambda s: rs.lr_schedule(s, warmup=warmup,
                                         decay_steps=decay, kind=kind))
    for s in list(range(0, 130)) + list(range(130, decay + 50, 97)):
        want = f(jnp.int32(s))
        got = lr_schedule(torch.tensor(s, dtype=torch.int32), warmup=warmup,
                          decay_steps=decay, kind=kind)
        if kind == "cosine":
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       err_msg=f"{kind} {s}")
        else:
            assert np.array_equal(_bits(want), _bits(got.numpy())), (kind,
                                                                     s)
    with pytest.raises(ValueError):
        lr_schedule(0, kind="step")


def test_grad_clip_and_init():
    cfg = OptConfig(name="sgd", lr=1.0, grad_clip=1.0)
    p2, st = apply_flat(cfg, init_flat(cfg, 4, device="cpu"),
                        torch.zeros(4), torch.tensor([10.0, 0, 0, 0]))
    np.testing.assert_allclose(p2.numpy(), [-1.0, 0, 0, 0], rtol=1e-6)
    assert isinstance(st, FlatOptState) and st.m is None
    like = torch.ones(5, dtype=torch.bfloat16)
    st = init_flat(OptConfig(), 5, like=like)
    assert st.m.dtype == torch.float32 and st.v.shape == (5,)
    with pytest.raises(ValueError):
        init_flat(OptConfig(name="lion"), 4, device="cpu")
