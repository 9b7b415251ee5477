"""Tree-topology sweep on the PyTorch/CUDA port: bits/round and
critical-path latency across constellation shapes (twin of
``fig_tree_topologies.py``).

For each topology (chain, star, grid, Walker-delta, Walker-star, random
geometric) and each Algorithm 1–5 it measures exact §V bits from the tree
simulator beside the ``comm_cost`` tree closed forms and bounds, and the
aggregation critical path (serialize + propagate over per-link bandwidth
and latency). A schedule section cycles all six routed trees through one
padded ``(L, W)``; a section sets bandwidth-scaled Top-Q budgets
against the uniform one; the last runs the chain ring and two routed trees
through the rotated-segment lowering on a mesh of 8 ranks, all on the one
device (``cuda:0`` by default, the CPU with ``--device cpu``).

    python benchmarks/torch_fig_tree_topologies.py [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch_common import ALGS, PAPER, agg_config, device_line, paper_data, \
    parser

from repro_torch.agg import (TopologySchedule, bandwidth_budgets,
                             compile_plan, execute)
from repro_torch.agg.device import (client_mesh, ring_chain_plan,
                                    run_plan_segments_local)
from repro_torch.core import comm_cost as cc
from repro_torch.core.ring import segment_budget
from repro_torch.device import resolve_device
from repro_torch.fed import Simulator
from repro_torch.fed.topology import TreeTopology
from repro_torch.topo import graph as tg
from repro_torch.topo.routing import widest_path_tree
from repro_torch.topo.tree import round_latency_s

ROUNDS = 10
WARMUP = 4

TOPOLOGIES = {
    "chain-12": tg.path_graph(12),
    "star-12": tg.star_graph(12),
    "grid-3x4": tg.grid_graph(3, 4),
    "walker-delta-3x4": tg.walker_delta(3, 4),
    "walker-star-4x3": tg.walker_star(4, 3),
    "geo-12": tg.random_geometric(12, seed=7),
}


def measure(name: str, g: tg.ConstellationGraph, rounds: int = ROUNDS,
            device=None) -> list[str]:
    k = g.num_clients
    pc = dataclasses.replace(PAPER, num_clients=k)
    fed, _ = paper_data(k, per_client=60, device=device)
    topo = TreeTopology(g, routing="widest")
    tree = topo.tree()
    sub = tree.subtree_sizes()
    depths = tree.depths()
    lines = []
    for alg, kind in ALGS.items():
        sim = Simulator(pc, agg_config(kind), fed, local_lr=pc.lr,
                        tree_topology=topo, device=device)
        res = sim.run(rounds)
        bits = sum(res["bits"][WARMUP:]) / len(res["bits"][WARMUP:])
        lines.append(f"tree,{name},{alg},{bits:.0f},{depths.max()}")
    lines.append(f"tree,{name},IA (dense),"
                 f"{cc.dense_ia_bits_tree(k, pc.d, pc.omega):.0f},"
                 f"{depths.max()}")
    lines.append(f"tree,{name},routing (sparse),"
                 f"{cc.routing_sparse_bits_tree(depths, pc.d, pc.q, pc.omega):.0f},"
                 f"{depths.max()}")
    ql = max(1, round(0.1 * pc.q))
    lines.append(f"tree,{name},TC-SIA Prop2 bound,"
                 f"{cc.tc_sia_bits_bound_tree(sub, pc.d, pc.q - ql, ql, pc.omega):.0f},"
                 f"{depths.max()}")
    # critical path: CL-SIA constant payload per uplink
    per_hop = [cc.cl_sia_bits(1, pc.d, pc.q, pc.omega)] * k
    lat = round_latency_s(tree, per_hop)
    lines.append(f"tree,{name},CL-SIA critical-path ms,{lat * 1e3:.2f},"
                 f"{depths.max()}")
    return lines


def measure_time_varying(device=None) -> list[str]:
    """All six topologies cycled round-robin, every routed tree padded to
    one common (L, W)."""
    k = 12
    pc = dataclasses.replace(PAPER, num_clients=k)
    fed, _ = paper_data(k, per_client=60, device=device)
    sched = TopologySchedule.from_topologies(
        [TreeTopology(g, routing="widest").tree()
         for g in TOPOLOGIES.values()])
    sim = Simulator(pc, agg_config(ALGS["CL-SIA"]), fed, local_lr=pc.lr,
                    device=device)
    res = sim.run(2 * len(TOPOLOGIES), topology_schedule=sched)
    lines = [f"schedule,common-LxW,{sched.shape[0]}x{sched.shape[1]},"
             f"{len(sched.plans)} plans,1 shape"]
    for (name, _), b in zip(list(TOPOLOGIES.items()) * 2, res["bits"]):
        lines.append(f"schedule,{name},CL-SIA,{b:.0f},-")
    return lines


def measure_bandwidth_aware(device=None) -> list[str]:
    """Uniform vs bandwidth-scaled Top-Q budgets on a heterogeneous shell."""
    dev = resolve_device(device)
    g = tg.walker_delta(3, 4)          # intra 200M / inter 100M / ground 50M
    tree = widest_path_tree(g)
    k = tree.num_clients
    pc = dataclasses.replace(PAPER, num_clients=k)
    cfg = agg_config(ALGS["CL-SIA"])
    grads = torch.randn((k, pc.d),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    e = torch.zeros((k, pc.d), device=dev)
    w = torch.ones((k,), device=dev)
    uni = execute(cfg, compile_plan(tree), grads, e, w)
    bwa = execute(cfg, compile_plan(tree,
                                    q_budget=bandwidth_budgets(cfg, tree)),
                  grads, e, w)
    return [f"bw_budget,walker-delta-3x4,uniform,"
            f"{float(uni.stats.bits.sum()):.0f},-",
            f"bw_budget,walker-delta-3x4,bw-scaled,"
            f"{float(bwa.stats.bits.sum()):.0f},-"]


def measure_device_plans(device=None, ranks: int = 8, seg: int = 4096,
                         reps: int = 10) -> list[str]:
    """Chain ring vs routed tree plans on the rotated-segment lowering.

    Every plan runs through ``run_plan_segments_local`` on a mesh of
    ``ranks`` ranks, all on ``device``: the chain plan is the rotated
    ring; the trees are routed multi-device topologies. CL-SIA §V bits are
    topology-invariant, so what a tree buys is the critical path —
    ``round_latency_s`` falls with depth — while the measured round (host
    clock, synchronized) counts the levels and slots the lowering runs.
    """
    dev = resolve_device(device)
    k = ranks
    n = k * seg
    pc = dataclasses.replace(PAPER, num_clients=k)
    mesh = client_mesh(k, devices=[dev] * k)
    gen = torch.Generator().manual_seed(0)
    grads = list(torch.randn((k, n), generator=gen).to(dev))
    ef = list(torch.zeros((k, n), device=dev))
    cfg = dataclasses.replace(agg_config(ALGS["CL-SIA"]),
                              q=segment_budget(pc.q * k, k))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    graphs = {"chain-ring": None,
              f"grid-2x{k // 2}": tg.grid_graph(2, k // 2),
              f"walker-delta-2x{k // 2}": tg.walker_delta(2, k // 2)}
    per_hop = [cc.cl_sia_bits(1, n, cfg.q * k, pc.omega)] * k
    lines = []
    for name, g in graphs.items():
        if g is None:
            plan = ring_chain_plan(k)
            tree = widest_path_tree(tg.path_graph(k))
        else:
            tree = widest_path_tree(g)
            plan = compile_plan(tree)

        def step():
            return run_plan_segments_local(cfg, plan, mesh, grads, ef, 1.0,
                                           transport="static")

        _, _, st = step()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            _, _, st = step()
        sync()
        ms = (time.perf_counter() - t0) / reps * 1e3
        bits = sum(float(s.bits) for s in st)
        depth = k if g is None else tree.max_depth()
        lat = round_latency_s(tree, per_hop) * 1e3
        lines.append(f"device,{name},CL-SIA,{bits:.0f} bits,depth {depth}, "
                     f"crit-path {lat:.2f} ms, measured {ms:.1f} ms/round")
    return lines


def main(argv=None) -> list[str]:
    p = parser(__doc__)
    p.add_argument("--rounds", type=int, default=ROUNDS)
    args = p.parse_args(argv)
    print(device_line(args.device))
    lines = ["fig_tree,topology,algorithm,bits_per_round_or_ms,depth"]
    for name, g in TOPOLOGIES.items():
        lines.extend(measure(name, g, args.rounds, args.device))
    lines.extend(measure_time_varying(args.device))
    lines.extend(measure_bandwidth_aware(args.device))
    lines.extend(measure_device_plans(args.device))
    print("\n".join(lines))
    # headline: CL-SIA bits are topology-invariant (the closed form holds
    # on every tree) while the critical path tracks tree depth; the
    # schedule section runs all six trees at one padded shape; the
    # bandwidth-scaled budgets undercut the uniform budget's bits; on the
    # segments lowering CL-SIA's bits are the same on the ring and the
    # trees
    return lines


if __name__ == "__main__":
    main()
