"""Time-varying LEO topology demo on the PyTorch/CUDA port (twin of
``time_varying_topology.py``): per-round re-routing over one padded plan
shape.

A 3×4 Walker-delta shell trains the paper's MNIST logistic model while
its ISLs churn: a third of the way in, the seam ISL (1, 5) and the
intra-plane link (1, 2) drop out (occlusion / handover), forcing the
affected satellites onto longer routes; two thirds of the way in they come
back. All routes compile into ``AggPlan``s padded to ONE (L, W) level
schedule, so every round runs the level step at one lane count.

    python examples/torch_time_varying_topology.py [--device cpu] [--rounds 60]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.agg import TopologySchedule  # noqa: E402
from repro_torch.configs import PAPER  # noqa: E402
from repro_torch.core.algorithms import AggConfig, AggKind  # noqa: E402
from repro_torch.data import make_synthetic_mnist, partition_iid  # noqa: E402
from repro_torch.fed import Simulator  # noqa: E402
from repro_torch.topo.graph import walker_delta  # noqa: E402


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--rounds", type=int, default=60)
    args = p.parse_args(argv)
    rounds, dev = args.rounds, args.device
    down, up = rounds // 3, 2 * rounds // 3
    g = walker_delta(3, 4, gateways=(1, 7))
    k = g.num_clients
    pc = dataclasses.replace(PAPER, num_clients=k)

    train = make_synthetic_mnist(0, k * 150, device=dev)
    test = make_synthetic_mnist(1, 1000, device=dev)
    fed = partition_iid(train, k, torch.Generator().manual_seed(2))

    links = [(1, 5), (1, 2)]
    events = {down: (links, []), up: ([], links)}
    sched = TopologySchedule.from_link_events(g, events, rounds=rounds,
                                              routing="widest")
    print(f"link-event schedule: {len(sched.plans)} distinct routed trees "
          f"over {rounds} rounds, all padded to (L, W) = {sched.shape}")
    print("→ every re-route is a host-side plan swap at one level-step "
          "shape\n")

    sim = Simulator(pc, AggConfig(kind=AggKind.CL_SIA, q=pc.q), fed,
                    local_lr=pc.lr, device=dev)
    out = sim.run(rounds, test_x=test.x, test_y=test.y, eval_every=10,
                  topology_schedule=sched)

    print(f"round  acc    (ISLs (1,5) and (1,2) down rounds {down}-{up - 1})")
    for r, acc in out["accuracy"]:
        marker = "  ← re-routed around lost ISLs" if down <= r < up else ""
        print(f"{r:5d}  {acc:.3f}{marker}")
    print(f"\nbits/round stayed {out['bits'][-1] / 1e3:.1f} kbit "
          f"(CL-SIA constant-length, route-invariant)")
    out["schedule"] = sched
    return out


if __name__ == "__main__":
    main()
