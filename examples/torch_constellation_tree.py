"""Constellation-tree demo on the PyTorch/CUDA port (twin of
``constellation_tree.py``): a Walker-delta LEO shell training over routed
aggregation trees, with a gateway-adjacent relay failure mid-training.

A 3-plane × 4-satellite Walker-delta constellation (torus ISL mesh, ground
station uplinked to satellites 1 and 7) trains the paper's MNIST logistic
model with CL-SIA over the widest-path aggregation tree. A third of the way
in the gateway-adjacent satellite dies; routing re-roots its whole subtree
through surviving ISLs. It recovers two thirds of the way in and its
banked error-feedback mass drains.

    python examples/torch_constellation_tree.py [--device cpu] [--rounds 75]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import PAPER  # noqa: E402
from repro_torch.core.algorithms import AggConfig, AggKind  # noqa: E402
from repro_torch.data import make_synthetic_mnist, partition_iid  # noqa: E402
from repro_torch.fed import Simulator  # noqa: E402
from repro_torch.fed.topology import FailureSchedule, TreeTopology  # noqa: E402
from repro_torch.runtime.fault import banked_mass  # noqa: E402
from repro_torch.topo.graph import walker_delta  # noqa: E402


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--rounds", type=int, default=75)
    args = p.parse_args(argv)
    rounds, dev = args.rounds, args.device
    fail, recover = rounds // 3, 2 * rounds // 3
    # 12 satellites + ground-station PS with two gateway uplinks (sats 1
    # and 7) so the constellation survives losing a gateway-adjacent relay
    g = walker_delta(3, 4, gateways=(1, 7))
    k = g.num_clients
    pc = dataclasses.replace(PAPER, num_clients=k)

    train = make_synthetic_mnist(0, k * 150, device=dev)
    test = make_synthetic_mnist(1, 1000, device=dev)
    fed = partition_iid(train, k, torch.Generator().manual_seed(2))

    topo = TreeTopology(g, routing="widest")
    tree = topo.tree()
    plan = topo.plan()
    print("aggregation tree (client → parent, PS = -1):", tree.parent)
    print(f"depth {tree.max_depth()} vs chain depth {k} — "
          f"{k / tree.max_depth():.1f}× shorter critical path")
    print(f"compiled plan: level schedule (L, W) = {plan.shape}\n")

    sim = Simulator(pc, AggConfig(kind=AggKind.CL_SIA, q=pc.q), fed,
                    local_lr=pc.lr, tree_topology=topo, device=dev)
    failures = FailureSchedule(k, {fail: ([0], []), recover: ([], [0])})
    out = sim.run(rounds, test_x=test.x, test_y=test.y, eval_every=10,
                  failure_schedule=failures)

    print(f"round  acc    (gateway-adjacent sat 0 dead rounds "
          f"{fail}-{recover - 1})")
    for r, acc in out["accuracy"]:
        marker = ("  ← sat 0 down, subtree re-rooted"
                  if fail <= r < recover else "")
        print(f"{r:5d}  {acc:.3f}{marker}")
    healed = topo.tree(dead=(0,))
    print(f"\nhealed tree parents: {healed.parent}")
    print(f"bits/round stayed {out['bits'][-1] / 1e3:.1f} kbit "
          f"(CL-SIA constant-length property, topology-invariant)")
    bm = banked_mass(out["state"].ef)
    print(f"banked |e| per sat: {[f'{float(x):.1f}' for x in bm]}")
    print("note: the dead satellite's subtree kept aggregating through the "
          "re-rooted tree — only the dead node itself banked into EF.")
    return out


if __name__ == "__main__":
    main()
