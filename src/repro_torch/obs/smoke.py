"""Telemetry smoke driver — ``python -m repro_torch.obs.smoke --out DIR``
(port of :mod:`repro.obs.smoke`, its host part).

Runs short :class:`~repro_torch.fed.simulator.Simulator` experiments over
the paths the trace subsystem must cover — flat chain, routed
constellation tree (link model → critical path), nested two-stage plan —
writing one JSONL trace + Chrome export per scenario, then validates every
trace and cross-checks its totals against the returned curves. The rounds
run on ``--torch-device`` (default ``cuda``). ``--device`` (the
reference's multi-device backend runs) is ROADMAP A12 and raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch


def _sims(pc, fed, device):
    """→ [(name, Simulator)] covering the host paths."""
    import repro_torch.topo.graph as tg
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.fed.simulator import Simulator
    from repro_torch.fed.topology import TreeTopology
    from repro_torch.topo.routing import cluster_routed

    cfg = AggConfig(kind=AggKind.CL_SIA, q=pc.q)
    k = pc.num_clients
    tree = TreeTopology(tg.walker_delta(2, k // 2, gateways=(1, k // 2)),
                        routing="widest")
    nested = cluster_routed(tg.grid_graph(2, k // 2), 2)
    kw = dict(local_lr=pc.lr, device=device)
    return [
        ("host_chain", Simulator(pc, cfg, fed, **kw)),
        ("host_tree", Simulator(pc, cfg, fed, tree_topology=tree, **kw)),
        ("host_nested", Simulator(pc, cfg, fed, nested_topology=nested,
                                  **kw)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.smoke",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="traces", help="output directory")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--device", action="store_true",
                    help="the multi-device backend runs (not ported: "
                         "ROADMAP A12)")
    ap.add_argument("--torch-device", default=None,
                    help="torch device of the rounds (default: cuda)")
    args = ap.parse_args(argv)
    if args.device:
        raise ValueError("--device runs the multi-device backend, which is "
                         "not ported (ROADMAP A12)")

    from repro_torch.configs import PAPER
    from repro_torch.data import make_synthetic_mnist, partition_iid
    from repro_torch.obs import (TraceCollector, export_chrome_trace,
                                 iter_trace, validate_trace)
    from repro_torch.obs.report import print_summary, summarize

    pc = dataclasses.replace(PAPER, num_clients=args.clients)
    train = make_synthetic_mnist(0, args.clients * 40,
                                 device=args.torch_device)
    fed = partition_iid(train, args.clients,
                        torch.Generator().manual_seed(2))
    os.makedirs(args.out, exist_ok=True)

    failed = False
    for name, sim in _sims(pc, fed, args.torch_device):
        path = os.path.join(args.out, f"{name}.jsonl")
        with TraceCollector(path, meta={"scenario": name}) as col:
            out = sim.run(args.rounds, collector=col, flush_every=4)
        res = validate_trace(path)
        errs = list(res.pop("errors"))
        # the returned curves must reduce from the recorded per-hop stats
        rounds = [r for r in iter_trace(path) if r["kind"] == "round"]
        for r, rec in enumerate(rounds):
            if abs(rec["totals"]["bits"] - out["bits"][r]) > 0.5:
                errs.append(f"round {r}: trace bits "
                            f"{rec['totals']['bits']} != curve "
                            f"{out['bits'][r]}")
        if sim.trace_counter.count != 1:
            errs.append(f"{sim.trace_counter.count} input signatures "
                        f"(want 1)")
        chrome = export_chrome_trace(path)
        status = "OK" if not errs else "FAIL"
        print(f"[{status}] {name}: {res} → {path}, {chrome}")
        for e in errs[:10]:
            print(f"    {e}")
        failed = failed or bool(errs)
        print_summary(summarize(path))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
