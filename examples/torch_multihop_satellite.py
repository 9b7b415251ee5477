"""The paper's motivating scenario on the PyTorch/CUDA port (twin of
``multihop_satellite.py``): a satellite constellation chain with link
failures and stragglers.

A K = 12 chain trains while: (a) random compute stragglers miss round
deadlines (their updates bank into error feedback and arrive later); (b) a
relay dies a third of the way in and stops contributing; (c) it recovers
two thirds of the way in. Communication stays CL-SIA-constant throughout.
The straggler masks come from a seeded ``torch.Generator`` (the JAX twin
draws its own with ``jax.random``).

    python examples/torch_multihop_satellite.py [--device cpu] [--rounds 90]
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
from repro_torch.fed.topology import FailureSchedule  # noqa: E402
from repro_torch.runtime.fault import StragglerModel, banked_mass  # noqa: E402


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--k", type=int, default=12)
    p.add_argument("--rounds", type=int, default=90)
    args = p.parse_args(argv)
    k, rounds, dev = args.k, args.rounds, args.device
    fail, recover, relay = rounds // 3, 2 * rounds // 3, k // 2 - 1
    pc = dataclasses.replace(PAPER, num_clients=k)

    train = make_synthetic_mnist(0, k * 150, device=dev)
    test = make_synthetic_mnist(1, 1000, device=dev)
    fed = partition_iid(train, k, torch.Generator().manual_seed(2))

    sim = Simulator(pc, AggConfig(kind=AggKind.CL_SIA, q=pc.q), fed,
                    local_lr=pc.lr, device=dev)
    stragglers = StragglerModel(p_straggle=0.15)
    failures = FailureSchedule(k, {fail: ([relay], []),
                                   recover: ([], [relay])})

    def participate_fn(r, state):
        mask = stragglers.sample(torch.Generator().manual_seed(9000 + r), k)
        for dead in failures.dead_at(r):
            mask[dead] = 0.0          # dead node contributes nothing
        return mask

    out = sim.run(rounds, test_x=test.x, test_y=test.y, eval_every=10,
                  participate_fn=participate_fn)

    print(f"round  acc    (relay {relay} dead rounds {fail}-{recover - 1}; "
          f"15% stragglers/round)")
    for r, acc in out["accuracy"]:
        marker = f"  ← node {relay} down" if fail <= r < recover else ""
        print(f"{r:5d}  {acc:.3f}{marker}")
    bm = banked_mass(out["state"].ef)
    print(f"\nbits/round stayed {out['bits'][-1] / 1e3:.1f} kbit "
          f"(CL-SIA constant-length property)")
    print(f"banked |e| per node: {[f'{float(x):.1f}' for x in bm]}")
    print(f"note: node {relay}'s queued mass transmits after recovery — "
          "error feedback doubles as the straggler/failure recovery "
          "mechanism.")
    return out


if __name__ == "__main__":
    main()
