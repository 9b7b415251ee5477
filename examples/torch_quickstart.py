"""Quickstart on the PyTorch/CUDA port (twin of ``quickstart.py``).

Train a d = 7850 logistic regression over a K = 10 multi-hop chain with
each of the five sparse-IA algorithms (and dense IA) and print accuracy
and exact uplink bits.

    python examples/torch_quickstart.py [--device cpu] [--k 10] [--rounds 80]
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--rounds", type=int, default=80)
    args = p.parse_args(argv)
    k, dev = args.k, args.device
    pc = dataclasses.replace(PAPER, num_clients=k)

    train = make_synthetic_mnist(0, k * 150, device=dev)
    test = make_synthetic_mnist(1, 1000, device=dev)
    fed = partition_iid(train, k, torch.Generator().manual_seed(2))

    print(f"K={k} clients on a chain, d={pc.d}, Q={pc.q} (1% of d), "
          f"device {dev}\n")
    print(f"{'algorithm':12s} {'test acc':>8s} {'kbit/round':>11s} "
          f"{'vs dense IA':>11s}")
    dense_bits = k * pc.d * pc.omega
    results = {}
    for kind in (AggKind.SIA, AggKind.RE_SIA, AggKind.CL_SIA,
                 AggKind.TC_SIA, AggKind.CL_TC_SIA, AggKind.DENSE_IA):
        agg = AggConfig(kind=kind, q=pc.q, q_global=pc.q_global,
                        q_local=pc.q_local)
        sim = Simulator(pc, agg, fed, local_lr=pc.lr, device=dev)
        out = sim.run(args.rounds, test_x=test.x, test_y=test.y,
                      eval_every=args.rounds - 1)
        acc, bits = out["accuracy"][-1][1], out["bits"][-1]
        results[kind.value] = (acc, bits)
        print(f"{kind.value:12s} {acc:8.3f} {bits / 1e3:11.1f} "
              f"{dense_bits / bits:10.1f}x")
    return results


if __name__ == "__main__":
    main()
