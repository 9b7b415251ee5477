"""Tree-topology sweep on the PyTorch/CUDA port: bits/round and
critical-path latency across constellation shapes (twin of the host
sections of ``fig_tree_topologies.py``; its device-plan section waits for
the port's multi-device path).

For each topology (chain, star, grid, Walker-delta, Walker-star, random
geometric) and each Algorithm 1–5 it measures exact §V bits from the tree
simulator beside the ``comm_cost`` tree closed forms and bounds, and the
aggregation critical path (serialize + propagate over per-link bandwidth
and latency). A schedule section cycles all six routed trees through one
padded ``(L, W)``; a last section sets bandwidth-scaled Top-Q budgets
against the uniform one.

    python benchmarks/torch_fig_tree_topologies.py [--device cpu]
"""

from __future__ import annotations

import dataclasses

import torch
from torch_common import ALGS, PAPER, agg_config, device_line, paper_data, \
    parser

from repro_torch.agg import (TopologySchedule, bandwidth_budgets,
                             compile_plan, execute)
from repro_torch.core import comm_cost as cc
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
    print("\n".join(lines))
    # headline: CL-SIA bits are topology-invariant (the closed form holds
    # on every tree) while the critical path tracks tree depth; the
    # schedule section runs all six trees at one padded shape; the
    # bandwidth-scaled budgets undercut the uniform budget's bits
    return lines


if __name__ == "__main__":
    main()
