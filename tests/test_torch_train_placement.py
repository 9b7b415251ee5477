"""The train state placed by rank on meshes of several devices
(``repro_torch.train.step.init_state``/``place_state``,
``repro_torch.train.state.gather_state``, ``checkpoint.restore(mesh=,
specs=)``), on SMOKE configs:

* on meshes of one fake CPU device a rank (``cpu:r``: a fake tensor keeps
  its device index) — 4 × 1, 2 × 2, 2 × 2 × 1 nested and ``cohorts=2`` —
  every piece of master, moments, EF and stage EF sits on its rank's
  device, rank (k, m)'s param and ``tcs_prev`` tree (shard m by
  ``param_pspecs``, the replicated leaves whole) on its device, and each
  device holds of master, moments, EF and the params what one rank holds
  of them under ``state_shardings`` (``dryrun.rank_bytes``); a whole step
  under ``FakeTensorMode`` keeps that placement, and so does a restore;
* on real CPU meshes whose ranks alternate between ``cpu`` and ``cpu:0``
  (two mesh devices, one memory), three steps in ring, routed, nested and
  cohort forms, gathered with ``gather_state``, equal the same steps on
  ``["cpu"] * K`` bit for bit — the steps that ``test_torch_train_step.py``
  and ``test_torch_train_topologies.py`` hold to the reference; a placed
  state is saved and restored bit for bit;
* ``grad_clip`` (its Σ g² summed over the pieces) and ``telemetry`` on
  placed pieces against the reference's ``apply_flat`` and
  ``dead_banked_mass`` under ``jax.jit``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import OptConfig
from repro_torch.topo.tree import star_tree
from repro_torch.train import (TrainConfig, build_train_step, init_state,
                               state_shardings)
from repro_torch.train.state import (RankPieces, RankShards, abstract_like,
                                     gather_state, state_leaves)
from repro_torch.train.step import param_places, place_state, rank_device

torch.set_num_threads(1)

CFG = get_config("mamba2-130m", smoke=True)
# name → (mesh shape, axes, init/step keywords)
MESHES = {
    "4x1": ((4, 1), ("data", "model"), {}),
    "2x2": ((2, 2), ("data", "model"), {}),
    "2x2x1 nested": ((2, 2, 1), ("pod", "data", "model"),
                     {"topology": "hierarchical"}),
    "cohorts=2": ((2, 2), ("data", "model"), {"cohorts": 2}),
}


def _tc(kind="cl_sia", opt="adamw", **opt_kw) -> TrainConfig:
    return TrainConfig(agg=AggConfig(kind=AggKind(kind), q=1),
                       opt=OptConfig(name=opt, lr=1e-2, **opt_kw),
                       q_frac=0.05, agg_dtype="float32", ef_dtype="float32")


def _fake_mesh(shape, axes):
    return make_mesh(shape, axes, [f"cpu:{r}" for r in range(math.prod(shape))])


def _flat_leaves(state) -> dict:
    """The state's rank-placed leaves by name."""
    out = {"master": state.master, "opt.m": state.opt.m,
           "opt.v": state.opt.v, "ef": state.ef}
    for i, e in enumerate(state.stage_ef or ()):
        out[f"stage_ef/{i}"] = e
    return {k: v for k, v in out.items() if v is not None}


def _assert_placed(state, mesh, m_cols: int) -> None:
    for name, leaf in _flat_leaves(state).items():
        assert isinstance(leaf, RankPieces), name
        for r, piece in enumerate(leaf.pieces):
            assert piece.device == rank_device(mesh, *divmod(r, m_cols)), (
                name, r, piece.device)
    places = list(param_places(mesh))
    for tree in (state.params, state.tcs_prev):
        if tree is None:
            continue
        assert isinstance(tree, RankShards)
        assert list(zip(tree.devices, tree.cols)) == places
        for dev, t in zip(tree.devices, tree.trees):
            assert {x.device for x in state_leaves(t)} == {dev}
    assert state.step.device == mesh.devices[0]


@pytest.mark.parametrize("name", list(MESHES))
def test_init_state_places_each_piece_on_its_rank(name):
    shape, axes, kw = MESHES[name]
    mesh, tc = _fake_mesh(shape, axes), _tc()
    m_cols = shape[-1]
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = init_state(CFG, tc, mesh, None, **kw)
    _assert_placed(state, mesh, m_cols)
    # each device holds one rank's bytes of the flat leaves under the
    # reference's specs, and the params nowhere but on the (k, 0) devices
    whole = init_state(CFG, tc, dryrun._meta_mesh(mesh), None, **kw)
    specs = state_shardings(CFG, tc, mesh, **kw)
    for leaf_name, leaf in _flat_leaves(state).items():
        path = leaf_name.replace("/", ".").split(".")
        glob, spec = whole, specs
        for part in path:
            glob = glob[int(part)] if part.isdigit() else getattr(glob, part)
            spec = spec[int(part)] if part.isdigit() else getattr(spec, part)
        want = dryrun.rank_bytes(glob, spec, mesh)
        for piece in leaf.pieces:
            assert piece.numel() * piece.element_size() == want, leaf_name
    # each rank's param tree: one rank's bytes of the params
    want = dryrun.rank_bytes(whole.params, specs.params, mesh)
    for t in state.params.trees:
        assert sum(x.numel() * x.element_size()
                   for x in state_leaves(t)) == want
    held = {str(d): 0 for d in mesh.distinct()}   # the dry run's count
    for t in state_leaves(state):
        held[str(t.device)] += t.numel() * t.element_size()
    assert dryrun.device_state_bytes(CFG, tc, mesh, **kw) == held


@pytest.mark.parametrize("name", list(MESHES))
def test_a_fake_step_keeps_the_placement(name):
    shape, axes, kw = MESHES[name]
    mesh, tc = _fake_mesh(shape, axes), _tc()
    step = build_train_step(CFG, tc, mesh, **kw)
    _, w, p = step.round_inputs({"participate": [1.0] * (step.k_dp - 1)
                                 + [0.0]})
    coh = kw.get("cohorts", 1)
    live = dryrun.LiveBytes()
    with dryrun._own_schedules(), dryrun._as_kernels(live), \
            FakeTensorMode(allow_non_fake_inputs=True), live:
        state = init_state(CFG, tc, mesh, None, **kw)
        toks = torch.zeros(((coh,) if coh > 1 else ()) + (8, 16),
                           dtype=torch.int64, device=mesh.devices[0])
        cols, loss = step.phase1(state, {"tokens": toks, "labels": toks})
        new, metrics = step.finish(state, cols, loss, w, p)
    _assert_placed(new, mesh, shape[-1])
    for leaf_name, leaf in _flat_leaves(new).items():
        old = _flat_leaves(state)[leaf_name]
        assert leaf.index == old.index and leaf.shape == old.shape
    assert metrics["loss"].device == mesh.devices[0]


# real CPU meshes: form → (mesh shape, axes, train config, init/step keywords)
FORMS = {
    "ring sgd": ((2, 2), ("data", "model"), _tc(opt="sgd"), {}),
    "ring adamw cl_tc_sia": ((2, 2), ("data", "model"),
                             _tc(kind="cl_tc_sia"), {}),
    "routed star sia": ((4, 1), ("data", "model"), _tc(kind="sia"),
                        {"topology": star_tree(4)}),
    "nested": ((2, 2, 1), ("pod", "data", "model"), _tc(),
               {"topology": "hierarchical"}),
    "cohorts=2": ((2, 2), ("data", "model"), _tc(), {"cohorts": 2}),
}


def _steps(shape, axes, devices, tc, kw, n_steps=3, telemetry=False):
    mesh = make_mesh(shape, axes, devices)
    state = init_state(CFG, tc, mesh, torch.Generator().manual_seed(0),
                       **kw)
    step = build_train_step(CFG, tc, mesh, telemetry=telemetry, **kw)
    gen = torch.Generator().manual_seed(1)
    coh = kw.get("cohorts", 1)
    metrics = []
    for s in range(n_steps):
        toks = torch.randint(0, CFG.vocab_size,
                             ((coh,) if coh > 1 else ()) + (8, 16),
                             generator=gen)
        part = [1.0] * step.k_dp
        part[-1] = 0.0 if s == 1 else 1.0
        state, m = step(state, {"tokens": toks, "labels": toks.roll(-1, -1),
                                "participate": torch.tensor(part)})
        metrics.append(m)
    return mesh, state, metrics


def _assert_same(a, b) -> None:
    """Equal bit for bit, leaf by leaf in checkpoint order: two whole
    states, or two placed ones piece for piece and replica for replica."""
    pairs = [(a, b)]
    if isinstance(a.master, RankPieces):
        pairs = [(gather_state(a, "cpu"), gather_state(b, "cpu"))]
        for x, y in ((a.params, b.params), (a.tcs_prev, b.tcs_prev)):
            if x is not None:
                assert (x.devices, x.cols) == (y.devices, y.cols)
                pairs += list(zip(x.trees, y.trees))
        for x, y in zip(_flat_leaves(a).values(), _flat_leaves(b).values()):
            assert x.index == y.index
            pairs += [(list(x.pieces), list(y.pieces))]
    for x, y in pairs:
        la, lb = _flatten_with_paths(x), _flatten_with_paths(y)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, u), (_, v) in zip(la, lb):
            assert u.dtype == v.dtype and torch.equal(u, v), path


@pytest.mark.parametrize("form", list(FORMS))
def test_placed_steps_equal_the_unplaced_bit_for_bit(form):
    shape, axes, tc, kw = FORMS[form]
    n = math.prod(shape)
    _, whole, m_whole = _steps(shape, axes, ["cpu"] * n, tc, kw)
    mesh, placed, m_placed = _steps(shape, axes, ["cpu", "cpu:0"] * (n // 2),
                                    tc, kw)
    assert isinstance(placed.master, RankPieces)
    _assert_same(gather_state(placed, "cpu"), whole)
    for mw, mp in zip(m_whole, m_placed):
        assert mw.keys() == mp.keys()
        for key in mw:
            assert torch.equal(mw[key], mp[key]), key


def test_a_placed_state_is_saved_and_restored_bit_for_bit(tmp_path):
    shape, axes, tc, kw = FORMS["ring adamw cl_tc_sia"]
    mesh, state, _ = _steps(shape, axes, ["cpu", "cpu:0"] * 2, tc, kw,
                            n_steps=1)
    ckpt.save(str(tmp_path), 1, state)
    specs = state_shardings(CFG, tc, mesh)
    got = ckpt.restore(str(tmp_path), abstract_like(state), mesh=mesh,
                       specs=specs)
    _assert_same(got, state)
    # the global layout on disk: a whole template restores it unplaced
    whole = ckpt.restore(str(tmp_path), gather_state(state, "cpu"))
    _assert_same(whole, gather_state(state, "cpu"))
    _assert_same(place_state(whole, mesh, specs), state)
    with pytest.raises(ValueError, match="mesh= and specs="):
        ckpt.restore(str(tmp_path), abstract_like(state))
    # onto a mesh of one fake device a rank: each piece lands on its rank
    fake = _fake_mesh(shape, axes)
    with FakeTensorMode(allow_non_fake_inputs=True):
        landed = ckpt.restore(str(tmp_path), abstract_like(state), mesh=fake,
                              specs=state_shardings(CFG, tc, fake))
    _assert_placed(landed, fake, shape[-1])


def test_grad_clip_and_telemetry_on_pieces_against_the_reference():
    from repro.optim import optimizers as ref_opt
    from repro.runtime.fault import dead_banked_mass as ref_dead
    shape, axes, _, kw = FORMS["nested"]
    tc = _tc(grad_clip=0.05, weight_decay=0.01)
    n = math.prod(shape)
    mesh = make_mesh(shape, axes, ["cpu", "cpu:0"] * (n // 2))
    _, state, _ = _steps(shape, axes, mesh.devices, tc, kw, n_steps=1)
    step = build_train_step(CFG, tc, mesh, telemetry=True, **kw)
    toks = torch.randint(0, CFG.vocab_size, (8, 16),
                         generator=torch.Generator().manual_seed(7))
    part = [1.0, 0.0, 1.0, 1.0]
    batch, w, p = step.round_inputs({"tokens": toks,
                                     "labels": toks.roll(-1, -1),
                                     "participate": part})
    cols, loss = step.phase1(state, batch)
    agg, ef, stage_ef, _, _ = step.aggregate(cols, state.ef, state.stage_ef,
                                             w, p)
    master, opt, _, _, lr_scale = step.update(state, agg, w, p)
    g = gather_state(state, "cpu")
    total = float(np.float32(sum(np.float32(a) * np.float32(b)
                                 for a, b in zip(w, p))))
    ref_cfg = ref_opt.OptConfig(name="adamw", lr=1e-2, grad_clip=0.05,
                                weight_decay=0.01)
    ref_state = ref_opt.FlatOptState(jnp.asarray(g.opt.step.numpy()),
                                     jnp.asarray(g.opt.m.numpy()),
                                     jnp.asarray(g.opt.v.numpy()))
    want_p, want_o = jax.jit(ref_opt.apply_flat, static_argnums=0)(
        ref_cfg, ref_state, jnp.asarray(g.master.numpy()),
        jnp.asarray(agg.gather("cpu").numpy()) / total,
        jnp.asarray(lr_scale.numpy()))
    clip = float(np.sqrt(np.sum(np.square(agg.gather("cpu").numpy()
                                          / total))))
    assert clip > 0.05                       # the clip binds
    for got, want in ((master, want_p), (opt.m, want_o.m),
                      (opt.v, want_o.v)):
        want = torch.from_numpy(np.array(want))
        torch.testing.assert_close(got.gather("cpu"), want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
    # telemetry: Σ ‖e‖₁ over every EF tier and the non-participants' bank
    new, metrics = step.finish(state, cols, loss, w, p)
    e = jnp.asarray(new.ef.gather("cpu").numpy())
    tiers = [jnp.asarray(t.gather("cpu").numpy()) for t in new.stage_ef]
    mass = jax.jit(lambda e, ts: jnp.sum(jnp.abs(e)) + sum(
        jnp.sum(jnp.abs(t)) for t in ts))(e, tiers)
    dead = jax.jit(ref_dead)(e.reshape(step.k_dp, -1), jnp.asarray(part))
    assert float(dead) > 0
    np.testing.assert_allclose(float(metrics["ef_mass"]), float(mass),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ef_dead_mass"]), float(dead),
                               rtol=1e-5)
    assert torch.equal(new.ef.gather("cpu"), ef.gather("cpu"))
    assert all(torch.equal(a.gather("cpu"), b.gather("cpu"))
               for a, b in zip(new.stage_ef, stage_ef))


def test_a_step_refuses_a_state_of_the_other_form():
    shape, axes, tc, kw = FORMS["ring sgd"]
    mesh = make_mesh(shape, axes, ["cpu", "cpu:0"] * 2)
    whole = init_state(CFG, tc, make_mesh(shape, axes, ["cpu"] * 4),
                       torch.Generator().manual_seed(0))
    step = build_train_step(CFG, tc, mesh)
    toks = torch.zeros((8, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="placed by rank"):
        step(whole, {"tokens": toks, "labels": toks})


def test_the_dry_run_measures_one_rank_on_a_mesh_of_one_device_a_rank():
    """A train cell on one fake device a rank fills the reference's
    per-rank fields from the rank device with the largest peak; the
    per-rank argument and output bytes are the one-device run's."""
    from repro_torch.configs.base import ShapeSpec
    shape = ShapeSpec("train", 16, 8, "train")
    one = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    whole = dryrun.dry_run_cell(CFG, shape, one)
    rec = dryrun.dry_run_cell(CFG, shape, dryrun.rank_mesh(one))
    ma, ma1 = rec["memory_analysis"], whole["memory_analysis"]
    assert ma1["temp_size_in_bytes"] is ma1["peak_bytes_estimate"] is None
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert ma[key] == ma1[key]
    assert ma["temp_size_in_bytes"] > 0
    assert ma["peak_bytes_estimate"] == (ma["argument_size_in_bytes"]
                                         + ma["output_size_in_bytes"]
                                         + ma["temp_size_in_bytes"])
    assert rec["fits_one_card"] is True
    assert rec["rank_peak_bytes"] >= rec["device_peak_bytes"]
    assert rec["port_home_bytes"] == max(rec["port_device_bytes"])
    assert len(rec["port_device_bytes"]) == 4
    assert sum(rec["port_device_bytes"]) > whole["port_home_bytes"] \
        == whole["port_device_bytes"][0] > rec["port_home_bytes"]
    # ranks cpu:0, cpu, cpu, cpu (chip_smoke phase 14's form): one rank's
    # fields come from the device that holds one rank
    mixed = dryrun.dry_run_cell(CFG, shape, make_mesh(
        (4, 1), ("data", "model"), ["cpu:0", "cpu", "cpu", "cpu"]))
    assert mixed["rank_peak_device"] == mixed["device"] == "cpu:0"
    assert mixed["rank_peak_bytes"] == mixed["device_peak_bytes"]
    assert mixed["fits_one_card"] is True


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_lower_cell_fills_one_rank_on_every_train_mesh(monkeypatch,
                                                       mesh_shape):
    """``lower_cell`` of a train cell (a SMOKE config at a small shape):
    on one rank the one-device run is the rank's, on several ranks a
    second run with one fake device a rank fills the per-rank fields."""
    from repro_torch.configs.base import ShapeSpec
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, smoke=True))
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeSpec("train_4k", 16, 8, "train"))
    rec = dryrun.lower_cell("mamba2-130m", "train_4k", multi_pod=False,
                            mesh_shape=mesh_shape, verbose=True)
    ma = rec["memory_analysis"]
    assert rec["status"] == "ok" and ma["temp_size_in_bytes"] > 0
    assert ma["peak_bytes_estimate"] == (ma["argument_size_in_bytes"]
                                         + ma["output_size_in_bytes"]
                                         + ma["temp_size_in_bytes"])
    assert rec["fits_one_card"] is True
    assert len(rec["port_device_bytes"]) == math.prod(mesh_shape)
    assert rec["port_fits_one_card"] is True
