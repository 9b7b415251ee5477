"""The port's dry run (``repro_torch.launch.dryrun``) against the reference.

Two reference subprocesses (8 fake XLA devices) start with the module and
run while the port's fake runs do: it gives ``repro.train.state_shardings``
as spec lists and ``memory_analysis()`` of the reference's compiled step
for SMOKE dense, MoE, SSM and hybrid configs × train, prefill and decode on
(2, 2) and (2, 2, 2) meshes. The port's per-rank argument and output bytes
must equal XLA's exactly, and its spec trees the reference's spec for
spec.
"""

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import weakref
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_cells
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as model_mod
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train import TrainConfig, init_state, state_shardings

REPO = Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
FAMILIES = ("phi4-mini-3.8b", "mixtral-8x7b", "mamba2-130m", "zamba2-1.2b")
KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 16, 8
# state_shardings cases: (name, mesh, agg kind, optimizer, topology, cohorts)
SPEC_CASES = [
    ("ring adamw cl_sia", "2x2", "cl_sia", "adamw", None, 1),
    ("ring sgd cl_tc_sia", "2x2", "cl_tc_sia", "sgd", None, 1),
    ("ring momentum cl_sia", "2x2x2", "cl_sia", "momentum", None, 1),
    ("hierarchical adamw cl_tc_sia", "2x2x2", "cl_tc_sia", "adamw",
     "hierarchical", 1),
    ("hierarchical sgd cl_sia", "2x2x2", "cl_sia", "sgd", "hierarchical", 1),
    ("cohorts=2 adamw cl_tc_sia", "2x2", "cl_tc_sia", "adamw", None, 2),
    ("cohorts=2 momentum cl_sia", "2x2x2", "cl_sia", "momentum", None, 2),
]

_REFERENCE = r'''
import json, os
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.core.algorithms import AggConfig, AggKind
from repro.launch import specs as specs_mod
from repro.launch.mesh import make_mesh
from repro.models import model as model_mod, partition
from repro.optim.optimizers import OptConfig
from repro.train.state import TrainConfig
from repro.train.step import (build_prefill_step, build_serve_step,
                              build_train_step, init_state, state_shardings)

MESHES = {MESHES}
FAMILIES, KINDS, SEQ, BATCH = {FAMILIES}, {KINDS}, {SEQ}, {BATCH}
SPEC_CASES = {SPEC_CASES}
COMPILE = {COMPILE}


def walk(tree, path=""):
    if tree is None:
        return []
    if isinstance(tree, NamedSharding):
        return [(path, [(e[0] if len(e) == 1 else list(e))
                        if isinstance(e, tuple) else e for e in tree.spec])]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in walk(getattr(tree, f), path + "/" + f)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in walk(tree[k], path + "/" + k)]
    return [x for i, t in enumerate(tree) for x in walk(t, f"{{path}}/{{i}}")]


out = {{"specs": {{}}, "memory": {{}}}}
for name, mname, kind, opt, topo, coh in SPEC_CASES:
    mesh = make_mesh(*MESHES[mname])
    tc = TrainConfig(agg=AggConfig(kind=AggKind(kind), q=1),
                     opt=OptConfig(name=opt))
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    out["specs"][name] = walk(state_shardings(cfg, tc, mesh, topology=topo,
                                              cohorts=coh))

tc = TrainConfig(agg=AggConfig(kind=AggKind.CL_SIA, q=1),
                 opt=OptConfig(name="adamw", lr=3e-4), q_frac=0.01)
for mname in COMPILE:
    mesh = make_mesh(*MESHES[mname])
    dpx = partition.batch_axes(mesh)
    ns = lambda s: NamedSharding(mesh, s)
    isp = lambda x: isinstance(x, P)
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True)
        for kind in KINDS:
            sh = ShapeSpec(kind, SEQ, BATCH, kind)
            with compat.set_mesh(mesh):
                if kind == "train":
                    st = jax.eval_shape(lambda: init_state(
                        cfg, tc, mesh, jax.random.PRNGKey(0)))
                    bsh = jax.tree.map(ns, partition.batch_pspecs(
                        cfg, mesh, BATCH), is_leaf=isp)
                    low = jax.jit(build_train_step(cfg, tc, mesh),
                                  in_shardings=(state_shardings(cfg, tc,
                                                                mesh), bsh)
                                  ).lower(st, specs_mod.train_batch_specs(
                                      cfg, sh))
                else:
                    ps = jax.eval_shape(lambda: model_mod.init_params(
                        cfg, jax.random.PRNGKey(0)))
                    psh = jax.tree.map(ns, partition.param_pspecs(cfg, mesh),
                                       is_leaf=isp)
                    csh = jax.tree.map(ns, partition.cache_pspecs(
                        cfg, mesh, BATCH), is_leaf=isp)
                    if kind == "prefill":
                        ins = specs_mod.prefill_specs(cfg, sh)
                        low = jax.jit(build_prefill_step(cfg, mesh),
                                      in_shardings=(psh, csh,
                                                    ns(P(dpx, None)))).lower(
                            ps, ins["cache"], ins["tokens"])
                    else:
                        ins = specs_mod.decode_specs(cfg, sh)
                        low = jax.jit(build_serve_step(cfg, mesh),
                                      in_shardings=(psh, csh, ns(P(dpx)),
                                                    ns(P()))).lower(
                            ps, ins["cache"], ins["token"], ins["pos"])
                ma = low.compile().memory_analysis()
            out["memory"][f"{{mname}} {{arch}} {{kind}}"] = [
                int(ma.argument_size_in_bytes), int(ma.output_size_in_bytes)]
print("PASS")
print(json.dumps(out))
'''


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's numbers, computed in two subprocesses started with
    the module (one per mesh; their compiles run while the port's fake runs
    do)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    procs = []
    for i, mname in enumerate(MESHES):
        script = _REFERENCE.format(
            MESHES=MESHES, FAMILIES=FAMILIES, KINDS=KINDS, SEQ=SEQ,
            BATCH=BATCH, SPEC_CASES=SPEC_CASES if i == 0 else [],
            COMPILE=[mname])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    result = {"specs": {}, "memory": {}}

    def get():
        for proc in procs:
            if proc.returncode is None:
                out, err = proc.communicate(timeout=600)
                assert proc.returncode == 0 and "PASS" in out, err[-4000:]
                got = json.loads(out.split("PASS", 1)[1])
                for k in result:
                    result[k].update(got[k])
        return result

    yield get
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, ["cpu"] * math.prod(shape))


@pytest.fixture(scope="module")
def cell():
    """One SMOKE cell's dry-run record; each runs once per module."""
    records: dict = {}

    def get(arch, kind, mname):
        if (arch, kind, mname) not in records:
            records[arch, kind, mname] = dryrun.dry_run_cell(
                get_config(arch, smoke=True),
                ShapeSpec(kind, SEQ, BATCH, kind), _mesh(mname))
        return records[arch, kind, mname]

    return get


@pytest.fixture(scope="module")
def full():
    """One full production cell (16 × 16) through ``lower_cell``."""
    records: dict = {}

    def get(arch, shape_name):
        if (arch, shape_name) not in records:
            records[arch, shape_name] = dryrun.lower_cell(
                arch, shape_name, multi_pod=False, verbose=False)
        return records[arch, shape_name]

    return get


def _norm(spec):
    """A spec as the reference's JSON gives it: one-axis tuples as the
    axis (``PartitionSpec`` keeps them so), longer ones as lists."""
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, tuple)
            else e for e in spec]


def _walk(tree, path=""):
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _walk(getattr(tree, f), path + "/" + f)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _walk(tree[k], path + "/" + k)]
    if isinstance(tree, tuple) and all(isinstance(t, tuple) or t is None
                                       for t in tree) and tree \
            and path.endswith("stage_ef"):
        return [x for i, t in enumerate(tree)
                for x in _walk(t, f"{path}/{i}")]
    return [[path, _norm(tree)]]


# ---------------------------------------------------------------------------
# The port alone (these run while the reference compiles)
# ---------------------------------------------------------------------------

def test_core_exports_the_reference_names():
    import repro.core
    import repro_torch.core as core
    from repro_torch.core import AggConfig as A, Aggregator, run_chain
    assert core.__all__ == repro.core.__all__
    for name in core.__all__:
        assert getattr(core, name) is not None
    assert A is AggConfig and callable(run_chain) and callable(Aggregator)
    with pytest.raises(AttributeError):
        core.no_such_name  # noqa: B018


def test_model_flops_equal_the_reference_roofline_for_every_cell():
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        roofline = importlib.import_module("roofline")
    finally:
        sys.path.remove(str(REPO / "benchmarks"))
    from repro.configs import get_config as ref_config
    from repro.configs.base import SHAPES as REF_SHAPES
    for arch in ARCHS:
        for name in shape_cells(get_config(arch)):
            s = SHAPES[name]
            assert dryrun.model_flops_for(get_config(arch), s, s.kind) == \
                roofline.model_flops_for(ref_config(arch), REF_SHAPES[name],
                                         s.kind), (arch, name)


def test_port_home_bytes_equal_a_real_init_state(cell):
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    rec = cell("phi4-mini-3.8b", "train", "2x2")
    tc = dryrun.default_train_config()
    state = init_state(cfg, tc, _mesh("2x2"),
                       torch.Generator().manual_seed(0))
    assert rec["port_home_bytes"] == sum(
        t.nbytes for t in dryrun._leaves(state))
    # every piece of the state lives on the mesh's first device, which
    # holds the whole state where the reference shards it
    assert rec["device_argument_bytes"] >= rec["port_home_bytes"]
    assert rec["port_home_bytes"] > rec["memory_analysis"][
        "argument_size_in_bytes"]


def test_flops_equal_flop_counter_mode(cell):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.transformer import tree_leaves
    cfg = get_config("mixtral-8x7b", smoke=True)
    rec = cell("mixtral-8x7b", "prefill", "2x2")
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = dryrun._materialize(model_mod.param_specs(cfg), "cpu")
        cache = dryrun._materialize(model_mod.cache_specs(cfg, BATCH, SEQ),
                                    "cpu")
        tokens = torch.zeros((BATCH, SEQ), dtype=torch.int32)
        with FlopCounterMode(display=False) as fc:
            with torch.inference_mode():
                model_mod.prefill(cfg, params, tokens, cache)
    assert rec["flops"] == fc.get_total_flops() > 0
    assert len(tree_leaves(params)) > 0


def _left_out(field: str):
    """``_materialize`` with a planted omission: the train state's
    ``field`` (``"opt.v"`` or ``"ef"``) is made outside the live-bytes
    count and its storage marked as seen, so no later view of it counts
    it either: a predictor that forgot it."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    from repro_torch.train.state import TrainState
    make = dryrun._materialize

    def get(st):
        return st.opt.v if field == "opt.v" else st.ef

    def put(st, x):
        return (st._replace(opt=st.opt._replace(v=x)) if field == "opt.v"
                else st._replace(ef=x))

    def materialize(tree, device):
        if not isinstance(tree, TrainState):
            return make(tree, device)
        live, = [m for m in _get_current_dispatch_mode_stack()
                 if isinstance(m, dryrun.LiveBytes)]
        live.paused += 1
        try:
            part = make(get(tree), device)
        finally:
            live.paused -= 1
        st = part.untyped_storage()
        live._refs[id(st)] = weakref.ref(st)
        return put(make(put(tree, None), device), part)

    return materialize


@pytest.mark.parametrize("field", ["opt.v", "ef"])
def test_a_planted_omission_lowers_the_peak_by_its_bytes(cell, monkeypatch,
                                                         field):
    """A predictor that leaves out one piece of the state (AdamW's second
    moment, the error feedback) reads exactly that piece's bytes low: the
    card's gate on the device peak must be tighter than the piece's share
    of it to catch the omission (chip_smoke phase 13 checks that)."""
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    sound = cell("phi4-mini-3.8b", "train", "2x2")
    monkeypatch.setattr(dryrun, "_materialize", _left_out(field))
    planted = dryrun.dry_run_cell(cfg, ShapeSpec("train", SEQ, BATCH,
                                                 "train"), _mesh("2x2"))
    state = init_state(cfg, dryrun.default_train_config(), _mesh("2x2"),
                       torch.Generator().manual_seed(0))
    part = state.opt.v if field == "opt.v" else state.ef
    rounded = -(-part.nbytes // dryrun.ALLOC_ROUND) * dryrun.ALLOC_ROUND
    assert sound["device_peak_bytes"] - planted["device_peak_bytes"] == \
        rounded > 0


def test_live_bytes_peak_against_mem_tracker():
    """The dry run's own tracker against torch's MemTracker on one SMOKE
    forward and backward: within 1 % (the dry run rounds each storage up
    to 512 bytes, as the CUDA caching allocator does; MemTracker does not
    on the CPU)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.models.transformer import tree_leaves
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True),
                              remat=False)
    with FakeTensorMode(allow_non_fake_inputs=True):
        live = dryrun.LiveBytes()
        with live:
            params = dryrun._materialize(model_mod.param_specs(cfg), "cpu")
            leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
            tokens = torch.zeros((BATCH, 64), dtype=torch.int64)
        mt = MemTracker()
        mt.track_external(*leaves)
        with mt, live:
            loss, _ = model_mod.loss_fn(cfg, params, {"tokens": tokens,
                                                      "labels": tokens})
            grads = torch.autograd.grad(loss, leaves)
            del loss, grads
        theirs = mt.get_tracker_snapshot("peak")[torch.device("cpu")][
            "Total"]
    ours = live.peak["cpu"]
    assert 0.99 <= ours / theirs <= 1.01, (ours, theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_arch_runs_its_cells(cell, arch):
    """The four families on the (2, 2) mesh of the XLA comparison, the
    other archs on two DP ranks of one model column."""
    cfg = get_config(arch, smoke=True)
    mesh = (_mesh("2x2") if arch in FAMILIES else
            make_mesh((2, 1), ("data", "model"), ["cpu"] * 2))
    for kind in KINDS:
        shape = ShapeSpec(kind, SEQ, BATCH, kind)
        rec = (cell(arch, kind, "2x2") if arch in FAMILIES else
               dryrun.dry_run_cell(cfg, shape, mesh))
        ma = rec["memory_analysis"]
        assert rec["device_peak_bytes"] >= rec["device_argument_bytes"] > 0
        # one rank's transients are not measured; the device's are
        assert ma["temp_size_in_bytes"] is ma["peak_bytes_estimate"] is None
        assert rec["device_temp_bytes"] == max(0, (
            rec["device_peak_bytes"] - rec["device_argument_bytes"]
            - rec["device_output_bytes"]))
        assert rec["port_home_bytes"] == dryrun.home_bytes(cfg, shape, mesh)
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["kernel_mode"] == "ref"
        if kind == "train":
            assert rec["collectives"]["total"] > 0     # two DP ranks


@pytest.mark.parametrize("kind", [k.value for k in AggKind])
def test_every_agg_kind_runs_but_the_routing_cost_model(kind):
    """Every algorithm with a node step runs on fake tensors, the TCS
    mask's τ search included; routing is a cost model and fails."""
    cfg = dataclasses.replace(get_config("mamba2-130m", smoke=True),
                              num_layers=1)
    run = lambda: dryrun.dry_run_cell(  # noqa: E731
        cfg,
        ShapeSpec("train", SEQ, BATCH, "train"), _mesh("2x2"),
        agg_kind=kind)
    if kind == "routing":
        with pytest.raises(ValueError, match="no node step"):
            run()
    else:
        assert run()["memory_analysis"]["argument_size_in_bytes"] > 0


def test_stand_ins_answer_the_exact_top_q_select_on_long_rows():
    """Rows of at least 2^22 entries take the select and the compact
    wire's per-row nonzeros: mamba2-130m at full width, one layer, on
    two DP ranks."""
    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=1)
    rec = dryrun.dry_run_cell(cfg, ShapeSpec("train", 8, 2, "train"),
                              make_mesh((2, 1), ("data", "model"),
                                        ["cpu"] * 2))
    # one per lane row and level (2 ranks x 2 levels), one compact wire
    # payload per rank and level
    assert rec["stand_ins"] == {"_select_keep: no NaN": 4,
                                "_select_keep: q survivors": 4,
                                "_compact_rows: q nonzeros": 4}
    assert rec["collectives"]["format"] == "compact"


@pytest.mark.parametrize("arch,shape_name", [
    ("mamba2-130m", "long_500k"), ("mamba2-130m", "decode_32k"),
    ("glm4-9b", "decode_32k"), ("mamba2-130m", "prefill_32k")])
def test_full_cells_through_lower_cell(full, arch, shape_name):
    """Full widths and depth on the 16 × 16 mesh (a full train cell runs
    16 full-depth clients, minutes of fake dispatch: the CLI sweep has
    them). A serving cell runs split over the ranks: its second run, one
    fake device a rank, gives one rank's placed bytes and peak."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import partition
    rec = full(arch, shape_name)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    ma = rec["memory_analysis"]
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = make_production_mesh(devices=["cpu"] * 256)
    params = model_mod.param_specs(cfg)
    cache = model_mod.cache_specs(cfg, shape.global_batch, shape.seq_len)
    # every rank holds its blocks of the params and the cache by the specs
    assert rec["port_home_bytes"] == dryrun.rank_bytes(
        params, partition.param_pspecs(cfg, mesh), mesh) + dryrun.rank_bytes(
        cache, partition.cache_pspecs(cfg, mesh, shape.global_batch), mesh)
    assert len(set(rec["port_device_bytes"])) == 1
    assert rec["rank_peak_bytes"] >= rec["port_home_bytes"]
    assert ma["peak_bytes_estimate"] == (ma["argument_size_in_bytes"]
                                         + ma["output_size_in_bytes"]
                                         + ma["temp_size_in_bytes"])
    assert rec["fits_one_card"] is True
    # the one-device run holds every rank's blocks: the whole params and
    # cache at least
    whole = sum(t.nbytes for t in dryrun._leaves([params, cache]))
    assert rec["device_peak_bytes"] >= rec["device_argument_bytes"] >= whole
    assert rec["roofline"]["chips"] == 256
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")
    assert rec["roofline"]["model_flops"] == dryrun.model_flops_for(
        cfg, shape, shape.kind)


def test_a_raising_cell_is_a_fail_record_and_exit_1(tmp_path, monkeypatch):
    out = tmp_path / "dry.json"

    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "lower_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                     "--out", str(out)])
    assert e.value.code == 1
    rec, = json.loads(out.read_text())
    assert rec["status"] == "FAIL" and rec["error"] == "RuntimeError: planted"


def test_the_table_twin_prints_the_reference_table(full, tmp_path,
                                                  capsys):
    """The twin on the port's JSON prints the reference's table on the same
    records; where the per-rank peak is not measured (a mesh whose every
    device holds several ranks) the twin says so where the reference's
    script (which needs a number there) reads it as 0."""
    recs = [full("mamba2-130m", "long_500k"),
            {"arch": "mamba2-130m", "shape": "train_4k", "mesh": "16x16",
             "agg": "cl_sia", "status": "FAIL", "error": "x"}]
    assert recs[0]["memory_analysis"]["peak_bytes_estimate"] > 0
    path, gone = tmp_path / "dry.json", tmp_path / "gone.json"
    zero = tmp_path / "zero.json"
    path.write_text(json.dumps(recs))
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        ref = importlib.import_module("emit_experiments_table")
        twin = importlib.import_module("torch_emit_experiments_table")
    finally:
        sys.path.remove(str(REPO / "benchmarks"))
    ref.main(str(path))
    want = capsys.readouterr().out
    twin.main(str(path))
    assert capsys.readouterr().out == want
    assert "| mamba2-130m | long_500k |" in want
    for p, peak in ((gone, None), (zero, 0)):
        p.write_text(json.dumps([dict(recs[0], memory_analysis=dict(
            recs[0]["memory_analysis"], peak_bytes_estimate=peak))]
            + recs[1:]))
    ref.main(str(zero))
    want = capsys.readouterr().out
    assert want.count("| 0.0 |\n") == 1
    twin.main(str(gone))
    assert capsys.readouterr().out == want.replace("| 0.0 |\n",
                                                   "| not measured |\n")


# ---------------------------------------------------------------------------
# Against the reference (waits for the subprocess)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [c[0] for c in SPEC_CASES])
def test_state_shardings_equal_the_reference(reference, case):
    name, mname, kind, opt, topo, coh = next(c for c in SPEC_CASES
                                             if c[0] == case)
    tc = TrainConfig(agg=AggConfig(kind=AggKind(kind), q=1),
                     opt=OptConfig(name=opt))
    got = _walk(state_shardings(get_config("phi4-mini-3.8b", smoke=True),
                                tc, _mesh(mname), topology=topo,
                                cohorts=coh))
    assert got == reference()["specs"][case]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_cells_are_measured_per_rank(arch, kind):
    """A serving cell on (2, 2) ranks, one fake device a rank
    (``rank_mesh``): its step runs split over them, so the per-rank fields
    are filled, and a rank's peak is below the peak of one device that
    holds all four ranks."""
    cfg = get_config(arch, smoke=True)
    shape = ShapeSpec(kind, SEQ, BATCH, kind)
    one = dryrun.dry_run_cell(cfg, shape, _mesh("2x2"))
    per = dryrun.dry_run_cell(cfg, shape, dryrun.rank_mesh(_mesh("2x2")))
    ma = per["memory_analysis"]
    assert None not in (ma["temp_size_in_bytes"], ma["peak_bytes_estimate"],
                        per["fits_one_card"], per["rank_peak_bytes"],
                        per["rank_peak_device"])
    assert per["rank_peak_device"] in {f"cpu:{r}" for r in range(4)}
    assert per["rank_peak_bytes"] < one["device_peak_bytes"]
    assert per["port_home_bytes"] < one["port_home_bytes"]
    # the per-rank bytes do not depend on the devices the ranks are on
    assert ma["argument_size_in_bytes"] == one["memory_analysis"][
        "argument_size_in_bytes"]
    assert ma["output_size_in_bytes"] == one["memory_analysis"][
        "output_size_in_bytes"]


# (arch, kind, seq, mesh): mixtral's prefill of 512 tokens gives each DP
# group whole routing groups; at SEQ its groups route over the gathered
# batch, as every MoE decode does, and the cell runs in full
ONCE_CASES = [(a, k, SEQ, "2x2") for a in FAMILIES
              for k in ("prefill", "decode")] + [
    ("mixtral-8x7b", "prefill", 512, "2x2"),
    ("phi4-mini-3.8b", "decode", SEQ, "2x2x2")]


@pytest.mark.parametrize("arch,kind,seq,mname", ONCE_CASES)
def test_group_0_once_equals_every_group(monkeypatch, arch, kind, seq,
                                         mname):
    """A serving cell whose DP groups share no work runs group 0 once
    (``dryrun._serve_once``); on one device and on a device a rank its
    peaks, temporaries, FLOPs and traffic equal those of the split step
    run whole, every group computed."""
    cfg = get_config(arch, smoke=True)
    shape = ShapeSpec(kind, seq, BATCH, kind)
    gathered = cfg.family == "moe" and (kind == "decode" or seq == SEQ)
    for mesh in (_mesh(mname), dryrun.rank_mesh(_mesh(mname))):
        assert dryrun._serve_apart(cfg, shape, mesh) is not gathered
        once = dryrun.dry_run_cell(cfg, shape, mesh)
        with monkeypatch.context() as m:
            m.setattr(dryrun, "_serve_apart", lambda *a: False)
            whole = dryrun.dry_run_cell(cfg, shape, mesh)
        for key in ("device_peak_bytes", "device_temp_bytes", "flops",
                    "bytes_accessed", "rank_peak_bytes", "rank_peak_device",
                    "memory_analysis"):
            assert once.get(key) == whole.get(key), (key, str(mesh.devices[0]))


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_rank_bytes_equal_xla_memory_analysis(reference, cell, arch, kind,
                                              mname):
    ma = cell(arch, kind, mname)["memory_analysis"]
    want = reference()["memory"][f"{mname} {arch} {kind}"]
    assert [ma["argument_size_in_bytes"], ma["output_size_in_bytes"]] == want
    assert ma["alias_size_in_bytes"] == 0
