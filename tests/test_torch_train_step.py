"""The port's LM train step (``repro_torch.train.step``) against the
reference's (``repro.train.step``), and the reference's own properties.

Reference twins: ``tests/test_ring_shardmap.py:74-140`` (``TRAIN_STEP``)
and ``test_models_smoke.py::test_arch_smoke_train_step``. One background
subprocess runs every reference case (``tests/_torch_train.py``); the port
runs on ``["cpu"] * 8`` ranks.

* **Phases 2–3 bit for bit** on (4, 2), SGD: the same per-client gradients
  (numpy, from a seed) go through the reference's real step (its loss
  replaced by one whose gradient is the given ``G_k``: ``local_flatten``
  → ``threshold_for_topq`` → ``run_plan_segments_local`` → ``apply_flat``
  → ``local_unflatten`` inside ``shard_map``) and through the port's
  ``flatten_grads`` → ``finish``. Master, moments, EF, ``tcs_prev``,
  params and the stats are equal bit for bit (``agg_err_sq``, a sum in
  XLA's order, to rtol 1e-6). The optimizer is SGD, whose update
  ``p − lr·g`` XLA contracts to one FMA wherever it sits. How XLA
  contracts the momentum and AdamW updates depends on its fusion: the
  train step's ``b·m + g`` is two roundings where a standalone jitted
  ``apply_flat`` is one FMA (27 of 106,816 moments differ in the last
  bit), so those are held by ``tests/test_torch_optim.py``.
* **The whole step** of every SMOKE family (dense, MoE, SSM, hybrid) in
  f32 on (4, 1), 3 steps from the reference's initial state: the port's
  own run keeps the loss to rtol 1e-5; each step taken again from the
  reference's state before it has the loss to rtol 1e-5, the transmitted
  support (``ef == 0``) equal but for swaps of two candidates tied at the
  Q-th magnitude (gradients from two autograds differ in the last bits;
  the failure reports the gap between the swapped magnitudes, so a tie is
  told apart from a fault), and the step's change of master and params
  (new − old) the reference's to 1e-3 of that change's own scale
  (``_torch_train.step_change_error``), with one step's slack only where a
  tie swapped the support or AdamW's ``√v̂`` is below 1e3·eps (there
  ``m̂ / (√v̂ + eps)`` turns a last-bit gradient difference into a change
  of its own size). The worst case measured is 2.1e-6 of scale (MoE,
  step 1). The check fails on a planted fault that keeps the support,
  bits and nnz: the port's gradients negated, or the update left out.
* **The reference's properties** on the port: CL-SIA's loss falls over 5
  steps; DENSE_IA equals manual data parallelism + AdamW to 3e-5; a
  straggler banks its whole gradient; the ``telemetry`` metrics.
* **Remat changes nothing:** loss and gradients are equal with
  ``cfg.remat`` on and off.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_train import (SMOKE_FAMILIES, TINY, assert_same_support,
                          assert_step_close, batch_of, bits, case,
                          loose_coordinates, port_leaves, ref_state,
                          start_reference, tokens)
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as lm
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim import OptConfig, apply_tree, init_tree, lr_schedule
from repro_torch.train import TrainConfig, build_train_step, init_state

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
STEP_RTOL = 1e-3
ERR_RTOL = 1e-6
K, M = 4, 2

SGD = dict(name="sgd", lr=1e-2)
PHASE_CASES = [
    case("phase/cl_sia", kind="cl_sia", fake_grads=True, opt=SGD),
    case("phase/sia", kind="sia", fake_grads=True, opt=SGD),
    case("phase/cl_tc_sia", kind="cl_tc_sia", fake_grads=True, opt=SGD),
    case("phase/cl_tc_sia tied", kind="cl_tc_sia", fake_grads=True,
         tcs_delta=True, steps=1, opt=SGD),
    case("phase/dense_ia", kind="dense_ia", fake_grads=True, opt=SGD),
]
WHOLE_CASES = [case(f"whole/{fam}", mesh=(4, 1), arch=arch, steps=3)
               for fam, arch in SMOKE_FAMILIES.items()]
CASES = PHASE_CASES + WHOLE_CASES
BY_NAME = {c["name"]: c for c in CASES}


def _cfg(c) -> ModelConfig:
    if "arch" in c:
        return dataclasses.replace(get_config(c["arch"], smoke=True),
                                   param_dtype="float32")
    return ModelConfig(**c["tiny"])


def _tc(c) -> TrainConfig:
    t = c["tc"]
    return TrainConfig(agg=AggConfig(kind=AggKind(t["kind"]), q=1),
                       opt=OptConfig(**t["opt"]), q_frac=t["q_frac"],
                       agg_dtype="float32", ef_dtype="float32")


def _mesh(c):
    n = int(np.prod(c["mesh"]))
    return make_mesh(c["mesh"], c["axes"], ["cpu"] * n)


def _param_paths(cfg) -> list:
    return ["/".join(p) for p, _ in
            _flatten_with_paths(lm.param_specs(cfg))]


def _inputs() -> dict:
    inp = {}
    for i, c in enumerate(CASES):
        cfg = _cfg(c)
        rng = np.random.default_rng(100 + i)
        for s in range(c["steps"]):
            toks, labels = tokens(1000 * i + s, cfg.vocab_size)
            inp[f"{c['name']}/tokens/{s}"] = toks
            inp[f"{c['name']}/labels/{s}"] = labels
            if c["fake_grads"]:
                for p, leaf in zip(_param_paths(cfg),
                                   tree_leaves(lm.param_specs(cfg))):
                    inp[f"{c['name']}/G/{s}/{p}"] = (
                        0.05 * rng.standard_normal((K, *leaf.shape))
                    ).astype(np.float32)
        if c["tcs_delta"]:
            # Δ from a small set of values: many entries tie at τ_G
            for p, leaf in zip(_param_paths(cfg),
                               tree_leaves(lm.param_specs(cfg))):
                inp[f"{c['name']}/delta/{p}"] = (0.01 * rng.integers(
                    -2, 3, leaf.shape)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def reference():
    """Two reference subprocesses side by side: the phase cases and the
    whole steps."""
    inp = _inputs()
    futs = {}
    for group in (PHASE_CASES, WHOLE_CASES):
        keys = tuple(c["name"] for c in group)
        sub = {k: v for k, v in inp.items() if k.startswith(keys)}
        fut = start_reference(group, sub)
        futs.update({c["name"]: fut for c in group})
    return inp, futs


def _states_equal(name, got: dict, out: dict, prefix: str):
    for key, g in got.items():
        want = out[prefix + key]
        assert g.shape == want.shape, (name, key)
        assert np.array_equal(bits(g), bits(want)), (
            name, key, np.abs(g - want).max())


@pytest.mark.parametrize("name", [c["name"] for c in PHASE_CASES])
def test_phases_2_3_equal_the_reference_bit_for_bit(reference, name):
    inp, futs = reference
    out = futs[name].result()
    c = BY_NAME[name]
    cfg, tc, mesh = _cfg(c), _tc(c), _mesh(c)
    step = build_train_step(cfg, tc, mesh)
    st = ref_state(out, f"{name}/init/")
    paths = _param_paths(cfg)
    for s in range(c["steps"]):
        cols = []
        for k in range(K):
            g = [torch.as_tensor(inp[f"{name}/G/{s}/{p}"][k]) for p in paths]
            cols.append(step.flatten_grads(g, k))
        loss = torch.zeros(())
        st, m = step.finish(st, cols, loss, [0.25] * K, [1.0] * K)
        _states_equal(name, port_leaves(st), out, f"{name}/{s}/state/")
        for key in ("agg_bits", "agg_nnz", "lr_scale"):
            assert np.array_equal(bits(m[key].numpy()),
                                  bits(out[f"{name}/{s}/metrics/{key}"])), (
                name, s, key)
        np.testing.assert_allclose(m["agg_err_sq"].numpy(),
                                   out[f"{name}/{s}/metrics/agg_err_sq"],
                                   rtol=ERR_RTOL)
    if name.endswith("tied"):
        # the tied Δ keeps more than Q_G coordinates in the global mask
        # (|Δ| ≥ τ_G keeps every tie), and the ring's CL-TC-SIA takes the
        # compact wire of q_global + q_local slots, as the reference does
        from repro_torch.agg.device import _segments_compact
        masks = step.tcs_masks(ref_state(out, f"{name}/init/").params,
                               ref_state(out, f"{name}/init/").tcs_prev)
        kept = sum(int((mk > 0).sum()) for mk in masks)
        assert kept > step.qg_total, (kept, step.qg_total)
        assert _segments_compact(step.agg_cfg, step.seg, step.plan, True,
                                 "auto", True)


@pytest.mark.parametrize("family", list(SMOKE_FAMILIES))
def test_whole_step_equals_the_reference(reference, family):
    inp, futs = reference
    name = f"whole/{family}"
    out = futs[name].result()
    c = BY_NAME[name]
    cfg, tc, mesh = _cfg(c), _tc(c), _mesh(c)
    step = build_train_step(cfg, tc, mesh)
    chained = ref_state(out, f"{name}/init/")
    for s in range(c["steps"]):
        want_loss = out[f"{name}/{s}/metrics/loss"]
        # the port's own run: the loss stays with the reference's
        chained, m = step(chained, batch_of(inp, name, s))
        np.testing.assert_allclose(m["loss"].numpy(), want_loss,
                                   rtol=LOSS_RTOL, err_msg=f"{name} {s}")
        # one step from the reference's state: support, bits, state
        prev = f"{name}/init/" if s == 0 else f"{name}/{s - 1}/state/"
        st, m = step(ref_state(out, prev), batch_of(inp, name, s))
        np.testing.assert_allclose(m["loss"].numpy(), want_loss,
                                   rtol=LOSS_RTOL, err_msg=f"{name} {s}")
        got = port_leaves(st)
        want = {k: out[f"{name}/{s}/state/{k}"] for k in got}
        assert_same_support(got[".ef"], want[".ef"], f"{name} step {s}")
        for key in ("agg_nnz", "agg_bits"):
            assert np.array_equal(m[key].numpy(),
                                  out[f"{name}/{s}/metrics/{key}"]), key
        old = {k: out[prev + k] for k in got}
        assert_step_close(f"{name} step {s}", old, got, want, STEP_RTOL,
                          loose_coordinates(step, old, got, want),
                          3 * tc.opt.lr * float(m["lr_scale"].max()))


@pytest.mark.parametrize("fault", ["gradient sign", "no update"])
def test_whole_step_check_catches_a_wrong_update(reference, monkeypatch,
                                                 fault):
    """The whole step's check fails on a planted fault that Adam hides
    from the support, the bits and the nnz: the port's gradients negated,
    or the update left out."""
    inp, futs = reference
    name = "whole/dense"
    out = futs[name].result()
    c = BY_NAME[name]
    cfg, tc, mesh = _cfg(c), _tc(c), _mesh(c)
    step = build_train_step(cfg, tc, mesh)
    if fault == "gradient sign":
        inner = step.client_grad

        def negated(*args, **kw):
            g, loss = inner(*args, **kw)
            return [-x for x in g], loss
        monkeypatch.setattr(step, "client_grad", negated)
    prev = f"{name}/init/"
    st, m = step(ref_state(out, prev), batch_of(inp, name, 0))
    got = port_leaves(st)
    old = {k: out[prev + k] for k in got}
    want = {k: out[f"{name}/0/state/{k}"] for k in got}
    if fault == "no update":
        got.update({k: old[k] for k in got
                    if k.startswith((".master", ".params"))})
    assert_same_support(got[".ef"], want[".ef"], fault)
    for key in ("agg_nnz", "agg_bits"):
        assert np.array_equal(m[key].numpy(), out[f"{name}/0/metrics/{key}"])
    with pytest.raises(AssertionError, match="the step's change is off"):
        assert_step_close(fault, old, got, want, STEP_RTOL,
                          loose_coordinates(step, old, got, want),
                          3 * tc.opt.lr * float(m["lr_scale"].max()))


# ---------------------------------------------------------------------------
# The reference's own properties (test_ring_shardmap.py TRAIN_STEP), port only
# ---------------------------------------------------------------------------

def _tiny_run(kind, opt, participate=None, steps=1, telemetry=False,
              q_frac=0.05):
    cfg = ModelConfig(**TINY)
    mesh = make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    tc = TrainConfig(agg=AggConfig(kind=kind, q=1), opt=opt, q_frac=q_frac,
                     agg_dtype="float32", ef_dtype="float32")
    st = init_state(cfg, tc, mesh, torch.Generator().manual_seed(0))
    st0 = st
    step = build_train_step(cfg, tc, mesh, telemetry=telemetry)
    toks, labels = tokens(1, 256, (8, 32))
    batch = {"tokens": torch.as_tensor(toks).long(),
             "labels": torch.as_tensor(labels).long()}
    if participate is not None:
        batch["participate"] = torch.tensor(participate)
    ms = []
    for _ in range(steps):
        st, m = step(st, dict(batch))
        ms.append(m)
    return cfg, tc, st0, st, ms, batch


def test_cl_sia_loss_falls():
    _, _, _, _, ms, _ = _tiny_run(AggKind.CL_SIA,
                                  OptConfig(name="adamw", lr=1e-3), steps=5)
    losses = [float(m["loss"]) for m in ms]
    assert losses[-1] < losses[0], losses
    assert float(ms[-1]["agg_bits"]) > 0


def test_dense_ia_equals_manual_data_parallel_adamw():
    cfg, tc, st0, st, _, batch = _tiny_run(AggKind.DENSE_IA,
                                           OptConfig(name="adamw", lr=1e-3))
    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(st0.params)]
    from repro_torch.core.flat_layout import tree_structure, tree_unflatten
    p0 = tree_unflatten(tree_structure(st0.params), leaves)
    loss, _ = lm.loss_fn(cfg, p0, batch)
    g = tree_unflatten(tree_structure(st0.params),
                       torch.autograd.grad(loss, leaves))
    ref_p, _ = apply_tree(tc.opt, init_tree(tc.opt, st0.params), st0.params,
                          g, lr_schedule(torch.tensor(0), warmup=tc.lr_warmup,
                                         decay_steps=tc.lr_decay_steps))
    err = max(float((a - b).abs().max()) for a, b in
              zip(tree_leaves(st.params), tree_leaves(ref_p)))
    assert err < 3e-5, err


def test_straggler_banks_its_gradient():
    _, _, _, st, ms, _ = _tiny_run(AggKind.CL_SIA,
                                   OptConfig(name="adamw", lr=1e-3),
                                   participate=[1., 0., 1., 1.])
    assert np.isfinite(float(ms[0]["loss"]))
    assert float(st.ef[1].abs().sum()) > float(st.ef[0].abs().sum())


def test_tcs_variant_and_telemetry_metrics():
    _, _, _, st, ms, _ = _tiny_run(AggKind.CL_TC_SIA,
                                   OptConfig(name="sgd", lr=1e-2), steps=3,
                                   participate=[1., 1., 0., 1.],
                                   telemetry=True)
    m = ms[-1]
    assert set(m) == {"loss", "agg_bits", "agg_nnz", "agg_err_sq",
                      "lr_scale", "ef_mass", "ef_dead_mass"}
    assert np.isfinite(float(m["loss"])) and float(m["agg_bits"]) > 0
    np.testing.assert_allclose(float(m["ef_mass"]),
                               float(st.ef.abs().sum()), rtol=1e-6)
    np.testing.assert_allclose(float(m["ef_dead_mass"]),
                               float(st.ef[2].abs().sum()), rtol=1e-6)


@pytest.mark.parametrize("family", list(SMOKE_FAMILIES))
def test_remat_changes_nothing(family):
    cfg = dataclasses.replace(get_config(SMOKE_FAMILIES[family], smoke=True),
                              param_dtype="float32", num_layers=4)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks, labels = tokens(3, cfg.vocab_size, (2, 16))
    batch = {"tokens": torch.as_tensor(toks).long(),
             "labels": torch.as_tensor(labels).long()}
    outs = []
    for remat, nested in ((False, False), (True, False), (True, True)):
        c = dataclasses.replace(cfg, remat=remat, nested_remat=nested)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        from repro_torch.core.flat_layout import tree_structure, \
            tree_unflatten
        loss, _ = lm.loss_fn(c, tree_unflatten(tree_structure(params),
                                               leaves), batch)
        outs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    for loss, grads in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        for a, b in zip(grads, outs[0][1]):
            assert torch.equal(a, b)
