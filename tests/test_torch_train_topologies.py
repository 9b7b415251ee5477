"""The port's train step over routed, nested and cohort topologies against
the reference's.

Reference twins: ``tests/test_device_plan.py:290-340`` (``TRAIN_TOPOLOGY``:
star and grid plans on (4, 2), the default = the explicit ring plan),
``test_nested_device.py:281-330`` (``"hierarchical"`` on (2, 4, 1)), and
``test_batched_rounds.py:283-300`` (the cohort guards). One reference
subprocess (``tests/_torch_train.py``) runs every case on the tiny dense
model in f32; the port runs on ``["cpu"] * 8`` ranks, and each step is
taken from the reference's state before it:

* the loss to rtol 1e-5, ``agg_bits``/``agg_nnz`` (and
  ``agg_bits_relay``) equal, the transmitted support equal but for swaps
  at a tie, the step's change of master and params to 1e-3 of its own
  scale (as ``test_torch_train_step.py``'s whole step), the EF tiers to
  rtol 1e-4;
* ``cohorts=2`` equals two sequential steps of the port bit for bit, and
  the reference's cohort step to the same tolerances;
* nested topologies and cohorts raise the reference's ``ValueError``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_train import (TINY, assert_step_close, batch_of, case,
                          loose_coordinates, port_leaves, port_topology,
                          ref_state, start_reference, tokens)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.launch.mesh import dp_clients, make_agg_plan, make_mesh
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, build_train_step, init_state
from repro_torch.train.step import _cohort

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
STATE_RTOL = 1e-4
STEP_RTOL = 1e-3
# stage 0: a chain in pod 0, a star in pod 1 (per-cluster trees take the
# butterfly); stage 1: the chain over the two pods
PERM_NESTED = ["nested", [[[[0, 1, 2, 3], None], [[4, 5, 6, 7], "star"]],
                          [[[0, 1], None]]], 8]
CASES = [
    case("star", topology=["star", 4]),
    case("grid", topology=["grid", [2, 2]]),
    case("hierarchical", mesh=(2, 4, 1), axes=("pod", "data", "model"),
         topology="hierarchical"),
    case("nested per-cluster", mesh=(2, 4, 1),
         axes=("pod", "data", "model"), topology=PERM_NESTED,
         kind="cl_tc_sia"),
    case("cohorts", cohorts=2, kind="sia"),
]
BY_NAME = {c["name"]: c for c in CASES}


def _tc(c) -> TrainConfig:
    t = c["tc"]
    return TrainConfig(agg=AggConfig(kind=AggKind(t["kind"]), q=1),
                       opt=OptConfig(**t["opt"]), q_frac=t["q_frac"],
                       agg_dtype="float32", ef_dtype="float32")


def _mesh(c):
    return make_mesh(c["mesh"], c["axes"], ["cpu"] * int(np.prod(c["mesh"])))


def _inputs() -> dict:
    inp = {}
    for i, c in enumerate(CASES):
        for s in range(c["steps"]):
            shape = (c["cohorts"], 8, 16) if c["cohorts"] > 1 else (8, 16)
            toks, labels = tokens(500 + 10 * i + s, TINY["vocab_size"], shape)
            inp[f"{c['name']}/tokens/{s}"] = toks
            inp[f"{c['name']}/labels/{s}"] = labels
    return inp


@pytest.fixture(scope="module")
def reference():
    inp = _inputs()
    return inp, start_reference(CASES, inp)


def _close(name, key, got, want):
    np.testing.assert_allclose(
        got, want, rtol=STATE_RTOL,
        atol=STATE_RTOL * max(np.abs(want).max(), 1e-30),
        err_msg=f"{name} {key}")


def _same_support(got, want, what):
    from _torch_train import assert_same_support
    assert_same_support(got.reshape(-1, got.shape[-1]),
                         want.reshape(-1, want.shape[-1]), what)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_topology_step_equals_the_reference(reference, name):
    inp, fut = reference
    out = fut.result()
    c = BY_NAME[name]
    cfg, tc, mesh = ModelConfig(**TINY), _tc(c), _mesh(c)
    topo = port_topology(c["topology"], mesh)
    step = build_train_step(cfg, tc, mesh, topology=topo,
                            cohorts=c["cohorts"])
    for s in range(c["steps"]):
        prev = f"{name}/init/" if s == 0 else f"{name}/{s - 1}/state/"
        st, m = step(ref_state(out, prev), batch_of(inp, name, s))
        np.testing.assert_allclose(m["loss"].numpy(),
                                   out[f"{name}/{s}/metrics/loss"],
                                   rtol=LOSS_RTOL, err_msg=f"{name} {s}")
        for key in ("agg_bits", "agg_nnz", "agg_bits_relay"):
            if key in m or f"{name}/{s}/metrics/{key}" in out:
                assert np.array_equal(m[key].numpy(),
                                      out[f"{name}/{s}/metrics/{key}"]), key
        got = port_leaves(st)
        pre = f"{name}/{s}/state/"
        assert set(got) == {k[len(pre):] for k in out if k.startswith(pre)}
        _same_support(got[".ef"], out[pre + ".ef"], f"{name} step {s}")
        for key, g in got.items():
            if key.startswith(".stage_ef"):
                _close(name, key, g, out[pre + key])
        old = {k: out[prev + k] for k in got}
        want = {k: out[pre + k] for k in got}
        assert_step_close(f"{name} step {s}", old, got, want, STEP_RTOL,
                          loose_coordinates(step, old, got, want),
                          3 * tc.opt.lr * float(m["lr_scale"].max()))


def test_cohorts_equal_sequential_steps():
    c = BY_NAME["cohorts"]
    cfg, tc, mesh = ModelConfig(**TINY), _tc(c), _mesh(c)
    gen = torch.Generator().manual_seed(0)
    st = init_state(cfg, tc, mesh, gen, cohorts=2)
    step_b = build_train_step(cfg, tc, mesh, cohorts=2)
    step_1 = build_train_step(cfg, tc, mesh)
    inp = _inputs()
    seq = [_cohort(st, i) for i in range(2)]
    for s in range(2):
        batch = batch_of(inp, "cohorts", s)
        batch["participate"] = torch.tensor([1., 1., 0., 1.])
        st, m = step_b(st, batch)
        for i in range(2):
            bi = {"tokens": batch["tokens"][i], "labels": batch["labels"][i],
                  "participate": batch["participate"]}
            seq[i], mi = step_1(seq[i], bi)
            for key in mi:
                assert torch.equal(m[key][i], mi[key]), (s, i, key)
            want, got = port_leaves(seq[i]), port_leaves(_cohort(st, i))
            for key in want:
                assert np.array_equal(want[key], got[key]), (s, i, key)


def test_default_topology_is_the_ring_plan():
    cfg = ModelConfig(**TINY)
    mesh = make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    assert dp_clients(mesh) == 4
    tc = _tc(BY_NAME["star"])
    st = init_state(cfg, tc, mesh, torch.Generator().manual_seed(0))
    toks, labels = tokens(7, 256)
    batch = {"tokens": torch.as_tensor(toks).long(),
             "labels": torch.as_tensor(labels).long()}
    a, ma = build_train_step(cfg, tc, mesh)(st, batch)
    b, mb = build_train_step(cfg, tc, mesh,
                             topology=make_agg_plan(mesh))(st, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(a.master, b.master)


def test_cohorts_and_topologies_raise_the_reference_errors():
    cfg = dataclasses.replace(ModelConfig(**TINY), num_layers=1)
    mesh = make_mesh((1, 1), ("pod", "data"), ["cpu"])
    tc = TrainConfig(agg=AggConfig(kind=AggKind.SIA, q=1),
                     opt=OptConfig(name="sgd", lr=1e-2),
                     agg_dtype="float32", ef_dtype="float32")
    with pytest.raises(ValueError, match="flat topolog"):
        build_train_step(cfg, tc, mesh, topology="hierarchical", cohorts=2)
    with pytest.raises(ValueError, match="flat topolog"):
        init_state(cfg, tc, mesh, torch.Generator().manual_seed(0),
                   topology="hierarchical", cohorts=2)
    flat = make_mesh((4, 1), ("data", "model"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="needs ≥2 DP axes"):
        build_train_step(cfg, tc, flat, topology="hierarchical")
    with pytest.raises(ValueError, match="clients but the mesh provides"):
        from repro_torch.agg.device import ring_chain_plan
        build_train_step(cfg, tc, flat, topology=ring_chain_plan(3))
