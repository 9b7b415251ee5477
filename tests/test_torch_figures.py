"""The port's paper-figure scripts and examples, on the CPU at small K.

Each ``benchmarks/torch_*.py`` figure twin and ``examples/torch_*.py``
runs with ``--device cpu``, fewer clients and fewer rounds, and its rows
are held to the paper's claims as ``tests/test_e2e_fedsim.py`` holds the
simulator: the Fig 2a ordering, CL-SIA's bits equal to the §V closed form
(on every topology, and on the healed tree while a relay is down), and
CL-SIA's normalized efficiency equal to K.
"""

import importlib
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import PAPER
from repro_torch.core import comm_cost as cc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
D, Q = PAPER.d, PAPER.q


def _load(folder: str, name: str):
    path = str(REPO / folder)
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def _rows(lines, prefix):
    return [ln.split(",") for ln in lines if ln.startswith(prefix)]


def test_fig2a_ordering_and_closed_form(capsys):
    lines = _load("benchmarks", "torch_fig2a_comm_cost").main(
        ["--device", "cpu", "--ks", "4", "10", "--rounds", "12"])
    assert "# device: cpu" in capsys.readouterr().out
    bits = {(int(k), name): float(v) for _, k, name, v in
            _rows(lines, "fig2a,") if k != "K"}
    for k in (4, 10):
        assert bits[(k, "CL-SIA")] == cc.cl_sia_bits(k, D, Q)
        assert bits[(k, "IA (dense)")] == cc.dense_ia_bits(k, D)
    b = {name: v for (k, name), v in bits.items() if k == 10}
    assert b["CL-TC-SIA"] < b["CL-SIA"] < b["TC-SIA"] < b["SIA"]
    assert b["SIA"] == pytest.approx(b["RE-SIA"], rel=0.15)
    assert b["SIA"] < b["routing (sparse)"] < b["IA (dense)"]
    assert lines[-1].endswith("(OK)")


def test_fig2b_efficiency():
    lines = _load("benchmarks", "torch_fig2b_efficiency").main(
        ["--device", "cpu", "--ks", "8", "--rounds", "12"])
    eff = {name: float(v) for _, k, name, v in _rows(lines, "fig2b,8,")}
    assert eff["CL-SIA"] == pytest.approx(8, rel=1e-6)
    assert eff["SIA"] > 1.5 * 8
    assert eff["routing"] == (8 * 8 + 8) / 2
    assert lines[-1].startswith("# CL-SIA normalized/K = 1.000")


def test_fig3_convergence():
    lines = _load("benchmarks", "torch_fig3_convergence").main(
        ["--device", "cpu", "--k", "6", "--rounds", "40",
         "--eval-every", "13"])
    acc = {}
    for _, name, r, a in _rows(lines, "fig3,")[1:]:
        acc.setdefault(name, []).append((int(r), float(a)))
    assert set(acc) == {"SIA", "RE-SIA", "CL-SIA", "TC-SIA", "CL-TC-SIA"}
    for name, curve in acc.items():
        assert [r for r, _ in curve] == [0, 13, 26, 39]
        assert curve[-1][1] > curve[0][1], name
    assert acc["SIA"][-1][1] > 0.9 and acc["CL-SIA"][-1][1] > 0.9


def test_fig4_equal_bandwidth():
    lines = _load("benchmarks", "torch_fig4_equal_bandwidth").main(
        ["--device", "cpu", "--k", "4", "--rounds", "20",
         "--eval-every", "19"])
    assert lines[0].endswith(f"target_bits={cc.cl_sia_bits(4, D, Q):.0f}")
    qs = {name: int(q) for _, name, q, _, _ in _rows(lines, "fig4,")[1:]}
    assert qs["CL-SIA"] == Q
    # SIA's support grows along the chain: at CL-SIA's bits its Q is lower
    assert all(1 <= q < D for q in qs.values())
    assert qs["SIA"] < Q
    finals = [float(a) for _, _, _, r, a in _rows(lines, "fig4,")[1:]
              if r == "19"]
    assert len(finals) == 5 and all(0.0 <= a <= 1.0 for a in finals)


def test_fig_tree_topologies():
    lines = _load("benchmarks", "torch_fig_tree_topologies").main(
        ["--device", "cpu", "--rounds", "6"])
    k = 12
    cl = [float(v) for _, _, alg, v, _ in _rows(lines, "tree,")
          if alg == "CL-SIA"]
    assert len(cl) == 6 and set(cl) == {cc.cl_sia_bits_tree(k, D, Q)}
    dense = [float(v) for _, _, alg, v, _ in _rows(lines, "tree,")
             if alg == "IA (dense)"]
    assert set(dense) == {cc.dense_ia_bits_tree(k, D)}
    crit = {t: float(v) for _, t, alg, v, _ in _rows(lines, "tree,")
            if alg == "CL-SIA critical-path ms"}
    assert crit["walker-delta-3x4"] < crit["chain-12"]
    sched = _rows(lines, "schedule,")
    assert sched[0][3] == "6 plans"
    assert {float(r[3]) for r in sched[1:]} == {cc.cl_sia_bits_tree(k, D, Q)}
    bw = {r[2]: float(r[3]) for r in _rows(lines, "bw_budget,")}
    assert bw["bw-scaled"] < bw["uniform"] == cc.cl_sia_bits(k, D, Q)


def test_quickstart(capsys):
    res = _load("examples", "torch_quickstart").main(
        ["--device", "cpu", "--k", "6", "--rounds", "30"])
    assert "device cpu" in capsys.readouterr().out
    assert res["cl_sia"][1] == cc.cl_sia_bits(6, D, Q)
    assert res["dense_ia"][1] == cc.dense_ia_bits(6, D)
    assert res["sia"][0] > 0.9 and res["cl_sia"][0] > 0.9


def test_constellation_tree_example():
    out = _load("examples", "torch_constellation_tree").main(
        ["--device", "cpu", "--rounds", "30"])
    live = [11 if 10 <= r < 20 else 12 for r in range(30)]
    assert out["bits"] == [cc.cl_sia_bits_tree(n, D, Q) for n in live]
    assert out["accuracy"][-1][1] > 0.9


def test_multihop_satellite_example():
    out = _load("examples", "torch_multihop_satellite").main(
        ["--device", "cpu", "--rounds", "30"])
    assert all(b <= cc.cl_sia_bits(12, D, Q) for b in out["bits"])
    assert out["accuracy"][-1][1] > 0.9


def test_time_varying_topology_example():
    out = _load("examples", "torch_time_varying_topology").main(
        ["--device", "cpu", "--rounds", "30"])
    sched = out["schedule"]
    assert len(sched.plans) == 2 and len({p.shape for p in sched.plans}) == 1
    assert set(out["bits"]) == {cc.cl_sia_bits_tree(12, D, Q)}
    assert out["accuracy"][-1][1] > 0.9


def test_fig_tree_device_plans_small_k():
    """The segments section on a CPU mesh of 4 ranks: CL-SIA's bits are
    the per-segment chain closed form summed over the K segments, the same
    on the ring and both trees, whose depth is below the chain's."""
    from repro_torch.core.ring import segment_budget
    mod = _load("benchmarks", "torch_fig_tree_topologies")
    k, seg = 4, 256
    lines = mod.measure_device_plans("cpu", ranks=k, seg=seg, reps=2)
    rows = [ln.split(",") for ln in lines]
    assert [r[1] for r in rows] == ["chain-ring", "grid-2x2",
                                    "walker-delta-2x2"]
    q = segment_budget(Q * k, k)
    want = k * cc.cl_sia_bits(k, seg, q)
    assert {float(r[3].split()[0]) for r in rows} == {want}
    depth = [int(r[4].split()[1]) for r in rows]
    assert depth[0] == k and max(depth[1:]) < k
    assert all(float(r[5].split()[1]) > 0 for r in rows)
    assert all(r[6].strip().startswith("measured") for r in rows)


def test_serve_decode_example():
    """The twin of ``examples/serve_decode.py`` on the CPU: mixtral SMOKE's
    32-slot SWA ring (2 layers × K and V × batch 2 × 2 heads × 16, f32),
    decoded past the window."""
    out = _load("examples", "torch_serve_decode").main(
        ["--device", "cpu", "--batch", "2", "--prompt-len", "32",
         "--gen", "8"])
    assert out["tokens"].shape == (2, 8)
    assert out["cache_bytes"] == 2 * 2 * 2 * 32 * 2 * 16 * 4
    assert out["step_ms"] > 0


def test_train_lm_sia_example():
    """The twin of ``examples/train_lm_sia.py`` on the CPU: the 3M model
    with CL-SIA over four clients; the loss falls."""
    out = _load("examples", "torch_train_lm_sia").main(
        ["--device", "cpu", "--steps", "12", "--batch", "8", "--seq", "32"])
    losses = out["losses"]
    assert len(losses) == 12 and all(map(math.isfinite, losses))
    assert sum(losses[-3:]) < sum(losses[:3]), losses


def test_emit_experiments_table_twin(tmp_path, capsys):
    """The twin of ``emit_experiments_table.py`` on a small dry-run JSON:
    the ok cells of the mesh asked for, then the failure count."""
    rec = {"arch": "mamba2-130m", "shape": "decode_32k", "mesh": "16x16",
           "agg": "cl_sia", "status": "ok",
           "memory_analysis": {"peak_bytes_estimate": 2.5e9},
           "roofline": {"t_compute_s": 1e-6, "t_memory_s": 2e-4,
                        "t_collective_s": 0.0, "bottleneck": "memory",
                        "useful_flops_ratio": 0.5,
                        "roofline_fraction": 0.0025}}
    unmeasured = dict(rec, shape="long_500k",
                      memory_analysis={"peak_bytes_estimate": None})
    cells = [rec, unmeasured, dict(rec, mesh="2x16x16"),
             dict(rec, shape="train_4k", status="FAIL")]
    path = tmp_path / "dry.json"
    path.write_text(__import__("json").dumps(cells))
    _load("benchmarks", "torch_emit_experiments_table").main(str(path))
    lines = capsys.readouterr().out.splitlines()
    assert lines[2] == ("| mamba2-130m | decode_32k | 1e-06 | 0.0002 | 0 "
                        "| memory | 0.50 | 0.0025 | 2.5 |")
    assert lines[3] == ("| mamba2-130m | long_500k | 1e-06 | 0.0002 | 0 "
                        "| memory | 0.50 | 0.0025 | not measured |")
    assert len(lines) == 6 and lines[-1] == ("2 cells on 16x16; 1 failures "
                                             "total.")
    mem = {"argument_size_in_bytes": 1e9, "output_size_in_bytes": 5e8,
           "peak_bytes_estimate": None}
    port = dict(rec, memory_analysis=mem, port_home_bytes=3e9,
                device_peak_bytes=4e9, port_fits_one_card=True)
    path.write_text(__import__("json").dumps(
        [port, dict(port, mesh="2x16x16", device_peak_bytes=8e10,
                    port_fits_one_card=False)]))
    twin = _load("benchmarks", "torch_emit_experiments_table")
    twin.port_main(str(path))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "| arch | decode_32k |"
    assert lines[2] == "| mamba2-130m | 1.5 / 1.5 · 3 / 3 · 4 / 80 |"
    assert lines[-2].endswith("within 80 GB: mamba2-130m × decode_32k "
                              "(16x16).")
    assert lines[-1] == "1 cells × 2 meshes; 0 failures total."
