"""Phase 1 split over ``model`` (``repro_torch.models.tp``,
``TrainStep.client_cols``) against the reference's GSPMD compute.

* **The step against the reference** (i): three reference subprocesses
  (``tests/_torch_train.py``) run the reference's
  jitted step on 8 fake XLA devices; the port runs the same step on
  ``["cpu"] * 8`` ranks, where each client's work splits over its M ranks
  in the reference's form — tensor-parallel for ``dense`` (tied phi4 with
  pad slots in the vocabulary, and untied granite, whose one kv head is
  replicated over M = 2), ``moe``, ``vlm`` and ``audio`` (with their
  frontend inputs); batch over model for ``ssm``, ``hybrid``, a dense
  arch with ``fsdp_compute`` and mixtral with ``fsdp_compute`` on (4, 2)
  and (2, 4) (batch 8 × 1024, so each sub-batch holds whole 1024-token
  routing groups and the aux comes from the client-wide fractions; one
  step each, the others two); on
  (2, 4) phi4 (6 heads, which 4 does not
  divide, so its attention splits by query sequence, as the reference's
  ``_constrain_scores`` pins its scores; ``d_ff`` and the vocabulary
  split). F32: the port's own run keeps the loss to rtol
  1e-5; each step from the reference's state has the loss to rtol 1e-5,
  the support equal but for swaps at a tie and the change of master and
  params the reference's to 1e-3 of its scale
  (``_torch_train.assert_step_close``, as ``test_torch_train_step.py``).
* **Split columns = whole-model columns**: each column of a client's
  split gradient equals the same client's whole-model autograd gradient
  through ``local_flatten(·, m)`` to 2e-6 of its largest entry, in every
  family and form — mamba2 with a client batch of 3 on (2, 4) too, which
  4 does not divide, so it takes the tensor-parallel form (the
  reference's ``x.shape[0] % m`` rule) — and with remat on and off the
  split gradient is the same bit for bit.
* **The split is real** (ii), on a mesh of one fake device a rank
  (``dryrun.rank_mesh`` of (2, 2)): each rank's param tree holds exactly
  ``rank_bytes(params, param_pspecs)``; in a fake step no device makes a
  tensor whose last dimension is the padded vocabulary; every rank
  (k, m > 0) runs matrix products in phase 1.
* **No whole f32 master** (iii): no tensor the downlink makes on a placed
  mesh is as large as the f32 master (the PR-24 gather is caught by the
  same check).
* **Checkpoints** (iv): a state with sharded params is saved and restored
  bit for bit, onto its ranks by their specs, and the reference's
  checkpoint of its (4, 2) state restores into the port's placed state,
  its params shard for shard as ``convert.placed_params`` places them.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_train import (assert_same_support, assert_step_close, batch_of,
                          case, loose_coordinates, port_leaves, ref_state,
                          start_reference, tokens, tree_of)
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import partition
from repro_torch.optim import OptConfig
from repro_torch.train import (TrainConfig, build_train_step, init_state,
                               state_shardings)
from repro_torch.train.state import (RankShards, abstract_like, gather_state,
                                     state_leaves)
from repro_torch.train.step import param_places, place_state

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
STEP_RTOL = 1e-3
TIED = dict(tie_embeddings=True, vocab_size=500)     # padded to 512

# name → (case keywords, the port's expected phase-1 form, batch shape)
CASES = {
    "dense tied": (dict(arch="phi4-mini-3.8b", over=TIED),
                   "tensor_parallel", (8, 16)),
    "dense untied gqa": (dict(arch="granite-34b"), "tensor_parallel",
                         (8, 16)),
    "moe": (dict(arch="mixtral-8x7b"), "tensor_parallel", (8, 16)),
    "ssm": (dict(arch="mamba2-130m"), "batch_over_model", (8, 16)),
    "hybrid": (dict(arch="zamba2-1.2b"), "batch_over_model", (8, 16)),
    "vlm": (dict(arch="internvl2-26b"), "tensor_parallel", (8, 16)),
    "audio": (dict(arch="musicgen-medium"), "tensor_parallel", (8, 16)),
    "dense fsdp_compute": (dict(arch="codeqwen1.5-7b", fsdp=True),
                           "batch_over_model", (8, 16)),
    "2x4 dense": (dict(arch="phi4-mini-3.8b", mesh=(2, 4),
                       kind="cl_tc_sia"), "tensor_parallel", (8, 16)),
    # each client's sub-batches hold whole 1024-token routing groups
    "moe fsdp_compute": (dict(arch="mixtral-8x7b", fsdp=True, steps=1),
                         "batch_over_model", (8, 1024)),
    "2x4 moe fsdp_compute": (dict(arch="mixtral-8x7b", fsdp=True,
                                  mesh=(2, 4), steps=1),
                             "batch_over_model", (8, 1024)),
}
REF_CASES = [case(name, **kw) for name, (kw, _, _) in CASES.items()]
# the cases whose CL-SIA chain carries a tie's swap down to later clients
# (step 0's row 0 swaps two coordinates tied to 4e-7; the one the
# reference sent then displaces one coordinate in each of rows 1-2)
CASCADE = {"moe fsdp_compute"}
BY_NAME = {c["name"]: c for c in REF_CASES}


def _cfg(c):
    return dataclasses.replace(get_config(c["arch"], smoke=True),
                               param_dtype="float32", **c.get("over", {}))


def _tc(c, fsdp=None) -> TrainConfig:
    t = c["tc"]
    return TrainConfig(agg=AggConfig(kind=AggKind(t["kind"]), q=1),
                       opt=OptConfig(**t["opt"]), q_frac=t["q_frac"],
                       agg_dtype="float32", ef_dtype="float32",
                       fsdp_compute=t["fsdp"] if fsdp is None else fsdp)


def _mesh(c, devices=None):
    n = math.prod(c["mesh"])
    return make_mesh(c["mesh"], c["axes"], devices or ["cpu"] * n)


def _inputs(cases) -> dict:
    inp = {}
    for i, c in enumerate(cases):
        cfg = _cfg(c)
        shape = CASES[c["name"]][2]
        rng = np.random.default_rng(300 + i)
        for s in range(c["steps"]):
            toks, labels = tokens(3000 * i + s, cfg.vocab_size, shape)
            inp[f"{c['name']}/tokens/{s}"] = toks
            inp[f"{c['name']}/labels/{s}"] = labels
            emb = rng.standard_normal((*shape, cfg.d_model)).astype(
                np.float32)
            if cfg.frontend == "vision":
                inp[f"{c['name']}/frontend_embeds/{s}"] = emb
                inp[f"{c['name']}/frontend_mask/{s}"] = rng.random(shape) < .3
            elif cfg.frontend == "audio":
                inp[f"{c['name']}/frontend_embeds/{s}"] = 0.1 * emb
    return inp


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Three reference subprocesses side by side; the first case also
    writes the reference's checkpoint of its last state."""
    cases = [dict(c) for c in REF_CASES]
    cases[0]["ckpt"] = str(tmp_path_factory.mktemp("ref_ckpt"))
    inp = _inputs(cases)
    futs = {}
    for group in (cases[i::3] for i in range(3)):
        keys = tuple(c["name"] + "/" for c in group)
        sub = {k: v for k, v in inp.items() if k.startswith(keys)}
        fut = start_reference(group, sub)
        futs.update({c["name"]: fut for c in group})
    return inp, futs, cases[0]["ckpt"]


def test_fsdp_compute_changes_the_form_as_the_reference_does(reference):
    """``fsdp_compute`` moves a dense arch from the tensor-parallel form to
    batch over model; a batch that does not divide M keeps the
    tensor-parallel form; an MoE splits its batch only where each
    sub-batch holds whole routing groups (1024 tokens), and a client of
    32 tokens keeps the tensor-parallel form. (It comes first so that the
    reference subprocesses run beside the fake steps below.)"""
    c = BY_NAME["dense fsdp_compute"]
    mesh = _mesh(c)
    toks = torch.zeros((8, 16), dtype=torch.int64)
    plain = build_train_step(_cfg(c), _tc(c, fsdp=False), mesh)
    fsdp = build_train_step(_cfg(c), _tc(c), mesh)
    assert plain.phase1_form({"tokens": toks}) == "tensor_parallel"
    assert fsdp.phase1_form({"tokens": toks}) == "batch_over_model"
    assert fsdp.phase1_form({"tokens": toks[:4]}) == "tensor_parallel"
    one = make_mesh((8, 1), ("data", "model"), ["cpu"] * 8)
    assert build_train_step(_cfg(c), _tc(c), one).phase1_form(
        {"tokens": toks}) == "whole"
    moe = BY_NAME["moe"]
    moe_step = build_train_step(_cfg(moe), _tc(moe, fsdp=True), mesh)
    assert moe_step.phase1_form(
        {"tokens": torch.zeros((8, 1024), dtype=torch.int64)}
    ) == "batch_over_model"
    # 4 clients of 2 × 16 = 32 tokens: one routing group a client
    assert moe_step.phase1_form({"tokens": toks}) == "tensor_parallel"
    assert moe_step.phase1_form(
        {"tokens": torch.zeros((8, 512), dtype=torch.int64)}
    ) == "tensor_parallel"


# name → (arch, config fields, mesh, batch, the form the split takes)
COLUMN_CASES = {
    "dense tied": ("phi4-mini-3.8b", TIED, (2, 2), (4, 16),
                   "tensor_parallel"),
    "gqa M=2": ("granite-34b", {}, (2, 2), (4, 16), "tensor_parallel"),
    "heads not dividing M=4": ("phi4-mini-3.8b", {}, (1, 4), (4, 16),
                               "tensor_parallel"),
    "moe": ("mixtral-8x7b", {}, (2, 2), (4, 16), "tensor_parallel"),
    "vlm": ("internvl2-26b", {}, (2, 2), (4, 16), "tensor_parallel"),
    "audio": ("musicgen-medium", {}, (2, 2), (4, 16), "tensor_parallel"),
    "ssm": ("mamba2-130m", {}, (2, 2), (4, 16), "batch_over_model"),
    "ssm batch 3 on 2x4": ("mamba2-130m", {}, (2, 4), (6, 16),
                           "tensor_parallel"),
    "hybrid": ("zamba2-1.2b", {}, (2, 2), (4, 16), "batch_over_model"),
    "hybrid M=3": ("zamba2-1.2b", {}, (1, 3), (3, 16), "batch_over_model"),
    # fsdp_compute: sub-batches of 1024 tokens, one aux from the client's
    # fractions (2, 2 client rows over M = 2)
    "moe fsdp_compute": ("mixtral-8x7b", {}, (2, 2), (4, 1024),
                         "batch_over_model", dict(fsdp_compute=True)),
}


def _client_batch(cfg, shape, seed):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, shape, generator=g)
    batch = {"tokens": toks, "labels": toks.roll(-1, -1)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = torch.randn(*shape, cfg.d_model,
                                               generator=g)
        batch["frontend_mask"] = torch.rand(shape, generator=g) < 0.3
    elif cfg.frontend == "audio":
        batch["frontend_embeds"] = 0.1 * torch.randn(*shape, cfg.d_model,
                                                     generator=g)
    return batch


@pytest.mark.parametrize("name", list(COLUMN_CASES))
def test_split_columns_equal_the_whole_model_columns(name):
    arch, over, shape, bshape, form, *tc_over = COLUMN_CASES[name]
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="float32", **over)
    tc = TrainConfig(agg_dtype="float32", ef_dtype="float32",
                     **(tc_over[0] if tc_over else {}))
    mesh = make_mesh(shape, ("data", "model"), ["cpu"] * math.prod(shape))
    step = build_train_step(cfg, tc, mesh)
    state = init_state(cfg, tc, mesh, torch.Generator().manual_seed(0))
    batch = _client_batch(cfg, bshape, 1)
    assert step.phase1_form(batch) == form
    for k in range(step.k_dp):
        cols, loss = step.client_cols(state.params, batch, k)
        whole, want = step.client_grad(state.params, batch, k)
        torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
        for m, col in enumerate(cols):
            ref = step.layout.local_flatten(whole, m, torch.float32)
            err = float((col - ref).abs().max() / ref.abs().max())
            assert err <= 2e-6, (name, k, m, err)
    # the layer remat around the cross-device sums changes no bit
    plain = build_train_step(dataclasses.replace(cfg, remat=False), tc,
                             mesh)
    for a, b in zip(step.client_cols(state.params, batch, 0)[0],
                    plain.client_cols(state.params, batch, 0)[0]):
        assert torch.equal(a, b), name


class _Made(TorchDispatchMode):
    """Every op's tensor outputs: (op name, device, shape, dtype)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else [out]
        for t in outs:
            if isinstance(t, torch.Tensor):
                self.made.append((func.__name__, str(t.device),
                                  tuple(t.shape), t.dtype))
        return out


def _fake_step(c):
    """A step on (2, 2) ranks, one fake device a rank, batch 4 × 16 →
    (mesh, step, state, ops made in phase 1, ops made in the rest)."""
    cfg, tc = _cfg(c), _tc(c)
    mesh = dryrun.rank_mesh(make_mesh((2, 2), ("data", "model"),
                                      ["cpu"] * 4))
    step = build_train_step(cfg, tc, mesh)
    _, w, p = step.round_inputs({})
    live = dryrun.LiveBytes()
    rec1, rec2 = _Made(), _Made()
    with dryrun._own_schedules(), dryrun._as_kernels(live), \
            FakeTensorMode(allow_non_fake_inputs=True), live:
        state = init_state(cfg, tc, mesh, None)
        toks = torch.zeros((4, 16), dtype=torch.int64,
                           device=mesh.devices[0])
        with rec1:
            cols, loss = step.phase1(state, {"tokens": toks,
                                             "labels": toks})
        with rec2:
            step.finish(state, cols, loss, w, p)
    return mesh, step, state, rec1.made, rec2.made


@pytest.mark.parametrize("name", ["dense tied", "dense untied gqa", "moe",
                                  "ssm"])
def test_the_split_is_real_on_one_fake_device_a_rank(name):
    c = BY_NAME[name]
    cfg = _cfg(c)
    mesh, step, state, phase1, rest = _fake_step(c)
    # each rank's tree holds one rank's bytes of the params
    whole = init_state(cfg, _tc(c), dryrun._meta_mesh(mesh), None)
    want = dryrun.rank_bytes(whole.params,
                             state_shardings(cfg, _tc(c), mesh).params, mesh)
    assert isinstance(state.params, RankShards)
    assert list(zip(state.params.devices, state.params.cols)) == list(
        param_places(mesh))
    for t in state.params.trees:
        assert sum(x.numel() * x.element_size()
                   for x in state_leaves(t)) == want
    # the vocabulary divides M: in the tensor-parallel form no device
    # makes a whole-vocabulary tensor (batch over model gathers the
    # embedding whole on each rank, FSDP-style)
    assert cfg.padded_vocab % step.m == 0
    assert cfg.padded_vocab not in (cfg.d_model, cfg.d_ff)
    wide = [op for op in phase1 + rest if op[2] and op[2][-1]
            == cfg.padded_vocab]
    assert not wide or CASES[name][1] == "batch_over_model", wide[:3]
    # every rank (k, m > 0) runs matrix products in phase 1 (an SSM's
    # ranks each run their sub-batch)
    mm = {dev for op, dev, _, _ in phase1 if op.startswith(("mm", "bmm"))}
    for r in range(mesh.size):
        assert f"cpu:{r}" in mm, (r, sorted(mm))


def test_no_device_holds_a_whole_f32_master_in_the_downlink():
    c = BY_NAME["dense tied"]
    cfg, tc = _cfg(c), _tc(c)
    mesh = _mesh(c, ["cpu", "cpu:0"] * 4)
    step = build_train_step(cfg, tc, mesh)
    state = init_state(cfg, tc, mesh, torch.Generator().manual_seed(0))
    rec = _Made()
    with rec:
        params = step.downlink(state.master)
    big = [op for op in rec.made if op[3] == torch.float32
           and math.prod(op[2]) >= step.layout.d_flat]
    assert not big, big[:3]
    # the same check catches a whole master made on one device
    with rec:
        state.master.gather("cpu")
    assert any(op[3] == torch.float32 and math.prod(op[2])
               >= step.layout.d_flat for op in rec.made)
    # the downlink rebuilds each rank's shards of the params
    for a, b in zip(_flatten_with_paths(gather_state(params, "cpu")),
                    _flatten_with_paths(gather_state(state.params, "cpu"))):
        assert torch.equal(a[1], b[1]), a[0]


@pytest.mark.parametrize("name", list(CASES))
def test_split_step_equals_the_reference(reference, name):
    inp, futs, _ = reference
    out = futs[name].result()
    c = BY_NAME[name]
    cfg, tc, mesh = _cfg(c), _tc(c), _mesh(c)
    step = build_train_step(cfg, tc, mesh)
    assert step.phase1_form(batch_of(inp, name, 0)) == CASES[name][1]
    chained = ref_state(out, f"{name}/init/")
    for s in range(c["steps"]):
        want_loss = out[f"{name}/{s}/metrics/loss"]
        chained, m = step(chained, batch_of(inp, name, s))
        np.testing.assert_allclose(m["loss"].numpy(), want_loss,
                                   rtol=LOSS_RTOL, err_msg=f"{name} {s}")
        prev = f"{name}/init/" if s == 0 else f"{name}/{s - 1}/state/"
        st, m = step(ref_state(out, prev), batch_of(inp, name, s))
        np.testing.assert_allclose(m["loss"].numpy(), want_loss,
                                   rtol=LOSS_RTOL, err_msg=f"{name} {s}")
        got = port_leaves(st)
        want = {k: out[f"{name}/{s}/state/{k}"] for k in got}
        assert_same_support(got[".ef"], want[".ef"], f"{name} step {s}",
                            cascade=name in CASCADE)
        old = {k: out[prev + k] for k in got}
        assert_step_close(f"{name} step {s}", old, got, want, STEP_RTOL,
                          loose_coordinates(step, old, got, want),
                          3 * tc.opt.lr * float(m["lr_scale"].max()))


def _assert_same(a, b):
    la, lb = _flatten_with_paths(a), _flatten_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, u), (_, v) in zip(la, lb):
        assert u.dtype == v.dtype and torch.equal(u, v), path


def test_sharded_checkpoints_round_trip_and_cross_from_the_reference(
        reference, tmp_path):
    inp, futs, ref_dir = reference
    name = REF_CASES[0]["name"]
    out = futs[name].result()
    c = BY_NAME[name]
    cfg, tc = _cfg(c), _tc(c)
    mesh = _mesh(c, ["cpu", "cpu:0"] * 4)
    specs = state_shardings(cfg, tc, mesh)
    step = build_train_step(cfg, tc, mesh)
    state = ref_state(out, f"{name}/init/")
    placed = step(place_state(state, mesh, specs),
                  batch_of(inp, name, 0))[0]
    # the port's placed state, saved and restored onto its ranks
    ckpt.save(str(tmp_path), 1, placed)
    got = ckpt.restore(str(tmp_path), abstract_like(placed), mesh=mesh,
                       specs=specs)
    assert isinstance(got.params, RankShards)
    for x, y in zip(got.params.trees, placed.params.trees):
        _assert_same(x, y)
    _assert_same(gather_state(got, "cpu"), gather_state(placed, "cpu"))
    # each rank's tree is its shard of the whole params
    whole = gather_state(got, "cpu").params
    for m, tree in zip(got.params.cols, got.params.trees):
        _assert_same(tree, partition.rank_params(whole, specs.params, m,
                                                 step.m))
    # the reference's checkpoint of its last state, onto the port's ranks
    from_ref = ckpt.restore(ref_dir, abstract_like(placed), mesh=mesh,
                            specs=specs)
    last = f"{name}/{c['steps'] - 1}/state/"
    for key, leaf in port_leaves(gather_state(from_ref, "cpu")).items():
        np.testing.assert_array_equal(leaf, out[last + key], err_msg=key)
    # the reference's params (numpy) straight onto the ranks
    shards = convert.placed_params(tree_of(out, last + ".params"), cfg, mesh)
    assert (shards.devices, shards.cols) == (from_ref.params.devices,
                                             from_ref.params.cols)
    for x, y in zip(shards.trees, from_ref.params.trees):
        _assert_same(x, y)
