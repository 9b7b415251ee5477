"""Boundaries of the port: it never imports JAX or the JAX package, and its
entry points never quietly fall back to the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import PAPER
from repro_torch.core.algorithms import AggConfig
from repro_torch.data import FederatedData
from repro_torch.fed import Simulator
from repro_torch.kernels import level, ops

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def _scripts():
    """The port's figure twins and examples."""
    return (sorted((REPO / "benchmarks").glob("torch_*.py"))
            + sorted((REPO / "examples").glob("torch_*.py")))


def test_port_and_chip_smoke_never_import_jax_or_the_reference():
    files = ([p for _, p in _modules()] + [REPO / "chip_smoke.py"]
             + _scripts())
    assert len(_scripts()) >= 10
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    names = [name for name, _ in _modules()]
    code = ("import importlib, sys\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('PASS', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "PASS" in proc.stdout, proc.stderr


def test_importing_the_scripts_loads_no_jax():
    """Each figure twin and example imports (its ``main`` not run) without
    JAX or the JAX package in the process."""
    code = ("import importlib.util, sys\n"
            f"for path in {[str(p) for p in _scripts()]!r}:\n"
            "    sys.path.insert(0, path.rsplit('/', 1)[0])\n"
            "    spec = importlib.util.spec_from_file_location('m', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('PASS')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "PASS" in proc.stdout, proc.stderr


def _fed(k=3):
    return FederatedData(x=torch.zeros(k, 4, PAPER.input_dim),
                         y=torch.zeros(k, 4, dtype=torch.int64))


def test_simulator_without_a_device_raises_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(PAPER, AggConfig(), _fed())
    sim = Simulator(PAPER, AggConfig(), _fed(), device="cpu")
    assert sim.init().flat_w.device.type == "cpu"


def test_tree_simulator_and_aggregator_raise_where_there_is_no_card():
    from repro_torch.agg import Aggregator
    from repro_torch.fed.topology import TreeTopology
    from repro_torch.topo import walker_delta
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    topo = TreeTopology(walker_delta(1, 3), "widest")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(PAPER, AggConfig(), _fed(), tree_topology=topo)
    sim = Simulator(PAPER, AggConfig(), _fed(), tree_topology=topo,
                    device="cpu")
    assert sim.init().ef.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Aggregator(AggConfig(), 3, 7, topology=topo)
    agg = Aggregator(AggConfig(kind="tc_sia"), 3, 7, topology=topo,
                     device="cpu")
    state = agg.init_state()
    assert state.ef.device.type == state.tcs_prev.device.type == "cpu"


def test_error_feedback_state_without_a_device_raises_without_a_card():
    from repro_torch.core import error_feedback as ef
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ef.init_ef(3, 7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ef.init_ef_rank(7)
    assert ef.init_ef(3, 7, device="cpu").e.device.type == "cpu"
    assert ef.init_ef_rank(7, device="cpu").e.device.type == "cpu"


def test_kernel_entries_follow_the_tensors_device():
    before = [k.launches for k in level.KERNELS]
    g = torch.ones(2, 10)
    v = torch.ones(2)
    out = ops.sparsify_ef_level(g, g, None, v, v, v)
    assert out[0].device.type == "cpu"
    assert [k.launches for k in level.KERNELS] == before
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            level.chain_accum_level_cuda(g, g, v)


def test_batched_entry_points_follow_the_device_and_never_fall_back():
    """The batched round runs on the simulator's device (the card unless
    it was built with ``device="cpu"``, which a machine without a card
    needs); ``execute_batched`` and the scheduler run on their tensors'
    device, and ``kernel_mode="always"`` on CPU tensors raises rather
    than take the plain versions; the cohort-form kernels refuse CPU
    tensors."""
    from repro_torch.agg import (CohortRound, RoundScheduler, compile_plan,
                                 execute_batched)
    before = [k.launches for k in level.KERNELS]
    sim = Simulator(PAPER, AggConfig(kind="cl_tc_sia"), _fed(), device="cpu")
    out = sim.run_batched(1, seeds=[0, 1])
    assert out["state"].ef.device.type == "cpu"
    assert out["state"].ef.shape == (2, 3, PAPER.d)
    g = torch.ones(2, 3, 10)
    w = torch.ones(2, 3)
    plan = compile_plan(3)
    res = execute_batched(AggConfig(kind="tc_sia"), plan, g, g, w)
    assert res.aggregate.device.type == "cpu"
    sched = RoundScheduler(AggConfig(kind="tc_sia"))
    got = sched.submit([CohortRound(0, plan, g[0], g[0], w[0])])
    assert got[0].aggregate.device.type == "cpu"
    assert [k.launches for k in level.KERNELS] == before
    with pytest.raises(RuntimeError, match="always"):
        execute_batched(AggConfig(kind="tc_sia", kernel_mode="always"),
                        plan, g, g, w)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            level.chain_accum_level_cuda(g[0], g[0], w[0], torch.zeros(1, 10),
                                         gmask_cohorts=1)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path, env=dict(os.environ))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_nested_scenario_and_trace_entry_points_follow_the_device(tmp_path):
    """The nested executor, the scenario driver and the trace smoke driver
    run on the card unless asked for the CPU, and raise without one; the
    nested plan itself stays numpy on the host."""
    from repro_torch.agg import pod_ring_nested, zero_stage_ef
    from repro_torch.obs import smoke
    from repro_torch.scenario import preset
    from repro_torch.scenario import run as scenario_run
    nested = pod_ring_nested(2, 2)
    assert isinstance(nested.client_alive(), np.ndarray)
    assert zero_stage_ef(nested, 5, "cpu")[0].device.type == "cpu"
    sim = Simulator(PAPER, AggConfig(), _fed(4), nested_topology=nested,
                    device="cpu")
    assert [e.device.type for e in sim.init().stage_ef] == ["cpu"]
    with pytest.raises(ValueError, match="unknown backend"):
        scenario_run.run_scenario(preset("relay-cascade"), backend="tpu",
                                  device="cpu")
    if torch.cuda.is_available():
        return
    # the device backend needs one card per client unless a mesh is named,
    # and never takes the CPU by itself
    assert smoke.main(["--device", "--out", str(tmp_path),
                       "--torch-device", "cpu"]) == 2
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\]"):
        scenario_run.run_scenario(preset("relay-cascade"), backend="device",
                                  device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zero_stage_ef(nested, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nested.client_alive("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(PAPER, AggConfig(), _fed(4), nested_topology=nested)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenario_run.run_scenario(preset("relay-cascade"),
                                  out=str(tmp_path / "t.jsonl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smoke.main(["--out", str(tmp_path), "--rounds", "1"])


def test_client_mesh_needs_a_card_per_rank_and_never_takes_the_cpu(
        monkeypatch):
    """``client_mesh(K)`` takes K cards: it raises with fewer, and with
    none it names ``devices=['cpu'] * K`` instead of taking the CPU."""
    from repro_torch.agg.device import client_mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* 28"):
            client_mesh(28)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 28 devices, have 1"):
        client_mesh(28)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        client_mesh(2, devices=["cuda:0", "cuda:1"])
    assert client_mesh(28, devices=["cuda:0"] * 28).distinct() == (
        torch.device("cuda", 0),)


def test_device_backend_without_a_mesh_raises_where_there_is_no_card():
    from repro_torch.agg.device import ClientMesh
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="devices="):
        Simulator(PAPER, AggConfig(), _fed(4), device="cpu",
                  backend="device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClientMesh(devices=("cuda:0",) * 4)


def test_execute_sharded_never_moves_a_card_mesh_to_the_cpu(monkeypatch):
    """A mesh that names the card keeps the work there: given CPU rows it
    moves them to the card (which fails here) rather than stepping the
    ranks on the CPU."""
    from repro_torch.agg import compile_plan
    from repro_torch.agg.device import client_mesh, execute_sharded
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mesh = client_mesh(4, devices=["cuda:0"] * 4)
    monkeypatch.undo()
    stepped = []
    for name in ("cl_fuse_level", "cl_fuse_select_level"):
        monkeypatch.setattr(ops, name, lambda *a, **k: stepped.append(1))
    with pytest.raises((AssertionError, RuntimeError)):
        execute_sharded(AggConfig(q=3), compile_plan(4),
                        torch.zeros((4, 16)), torch.zeros((4, 16)),
                        torch.ones(4), mesh=mesh)
    assert not stepped


def test_device_module_imports_no_jax():
    path = PORT / "agg" / "device.py"
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}
    code = ("import sys, repro_torch.agg.device\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_segments_lowering_never_moves_a_card_mesh_to_the_cpu(monkeypatch):
    """The rotated-segment lowering, the ring and the hierarchical ring on
    a mesh that names the card move CPU rows to the card (which fails
    here) rather than stepping the ranks on the CPU."""
    from repro_torch.agg.device import client_mesh
    from repro_torch.core.hierarchical import hierarchical_ring_local
    from repro_torch.core.ring import rotated_ring_local
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mesh = client_mesh(4, devices=["cuda:0"] * 4)
    monkeypatch.undo()
    stepped = []
    for name in ("cl_fuse_level", "cl_fuse_select_level"):
        monkeypatch.setattr(ops, name, lambda *a, **k: stepped.append(1))
    rows = [torch.zeros(16)] * 4
    with pytest.raises((AssertionError, RuntimeError)):
        rotated_ring_local(AggConfig(q=3), mesh, rows, rows, 1.0)
    with pytest.raises((AssertionError, RuntimeError)):
        hierarchical_ring_local(AggConfig(q=3), mesh, rows, rows,
                                [torch.zeros(8)] * 4, 1.0, sizes=(2, 2))
    assert not stepped


def test_sharded_tau_search_stays_on_the_shards_devices():
    """Each shard counts on its own device and the sums land on the first
    shard's: CPU shards give a CPU τ, never a copy made elsewhere."""
    from repro_torch.core import sparsify as sp
    x = torch.arange(64, dtype=torch.float32) - 20
    tau = sp.threshold_for_topq(list(x.chunk(4)), 5, count_fn=ops.count_ge)
    assert tau.device.type == "cpu"
    assert torch.equal(tau, sp.threshold_for_topq(x, 5))


@pytest.mark.parametrize("module", ["repro_torch.core.ring",
                                    "repro_torch.core.hierarchical"])
def test_ring_modules_import_no_jax(module):
    path = PORT / Path(*module.split(".")[1:]).with_suffix(".py")
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}
    code = (f"import sys, {module}\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_lm_serving_entry_points_raise_where_there_is_no_card():
    """The LM stack runs on the card unless asked for the CPU: params,
    caches, stubs, the converted reference trees, ``generate`` and the
    serve CLI raise without one; the meta-device specs need no device."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as lm
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = get_config("mamba2-130m", smoke=True)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params({"x": np.zeros(2, np.float32)})
    params = lm.init_params(cfg, gen, "cpu")
    prompts = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.generate(cfg, params, prompts, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--gen", "2"])
    assert lm.param_specs(cfg)["embed"].is_meta
    assert lm.cache_specs(cfg, 1, 4)["layers"]["state"].is_meta
    out = serve.generate(cfg, params, prompts, 2, "cpu")
    assert out.tokens.device.type == "cpu" and out.tokens.shape == (1, 2)


def test_lm_training_entry_points_raise_where_there_is_no_card():
    """The train stack runs on the card unless asked for another device:
    meshes, the host mesh, the bigram data, ``convert.train_state`` and
    the train CLI raise without one; a mesh of CPU ranks trains."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_bigram_lm
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_cli
    from repro_torch.train import TrainConfig, build_train_step, init_state
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* 8"):
        mesh_mod.make_mesh((4, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_mod.make_host_mesh()
    with pytest.raises(RuntimeError):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_bigram_lm(0, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_mod.make_mesh((2, 1), ("data", "model"), ["cuda:0"] * 2)
    cfg = get_config("mamba2-130m", smoke=True)
    mesh = mesh_mod.make_mesh((2, 1), ("data", "model"), ["cpu"] * 2)
    tc = TrainConfig(agg_dtype="float32", ef_dtype="float32")
    st = init_state(cfg, tc, mesh, torch.Generator().manual_seed(0))
    assert st.master.device.type == "cpu" and st.ef.shape[0] == 2
    toks = torch.zeros((2, 8), dtype=torch.long)
    st, m = build_train_step(cfg, tc, mesh)(st, {"tokens": toks,
                                                 "labels": toks})
    assert m["loss"].device.type == "cpu" and int(st.step) == 1


def test_dry_run_imports_no_jax_and_nothing_of_the_reference():
    """``launch/dryrun.py`` counts its own bytes: it imports neither JAX,
    nor the JAX package, nor ``benchmarks/`` (the reference's roofline)."""
    code = ("import sys\n"
            "import repro_torch.launch.dryrun\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'roofline', 'hlo_analysis')]\n"
            "assert not bad, bad\n"
            "print('PASS')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "PASS" in proc.stdout, proc.stderr
    roots = _imported_roots(PORT / "launch" / "dryrun.py")
    assert not roots & {"jax", "jaxlib", "repro", "roofline",
                        "hlo_analysis"}, roots
