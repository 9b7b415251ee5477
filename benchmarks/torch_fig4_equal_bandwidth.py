"""Paper Fig. 4 on the PyTorch/CUDA port: test accuracy under
(approximately) equal bandwidth (twin of ``fig4_equal_bandwidth.py``).

Q is re-tuned per algorithm so each transmits ≈ the same bits/iteration as
CL-SIA at Q = 78 (98 kbit for K = 28). Paper result: CL-SIA, RE-SIA and
TC-SIA converge much faster than SIA, with CL-SIA best.

    python benchmarks/torch_fig4_equal_bandwidth.py [--device cpu] [--k 6]
"""

from __future__ import annotations

import dataclasses

from torch_common import ALGS, PAPER, agg_config, device_line, paper_data, \
    parser

from repro_torch.core import comm_cost as cc
from repro_torch.core.algorithms import AggKind
from repro_torch.fed import Simulator

ROUNDS = 150
EVAL_EVERY = 25


def tune_q(kind: AggKind, target_bits: float, pc, fed, device) -> int:
    """Bisect Q so measured bits/iteration ≈ target (paper's procedure)."""
    lo, hi = 1, pc.d
    for _ in range(10):
        mid = (lo + hi) // 2
        sim = Simulator(pc, agg_config(kind, q=mid), fed, local_lr=pc.lr,
                        device=device)
        bits = sim.run(6)["bits"][-1]
        if bits > target_bits:
            hi = mid
        else:
            lo = mid + 1
    return max(1, lo - 1)


def main(argv=None) -> list[str]:
    p = parser(__doc__)
    p.add_argument("--k", type=int, default=PAPER.num_clients)
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--eval-every", type=int, default=EVAL_EVERY)
    args = p.parse_args(argv)
    print(device_line(args.device))
    pc = dataclasses.replace(PAPER, num_clients=args.k)
    fed, test = paper_data(args.k, per_client=120, device=args.device)
    target = cc.cl_sia_bits(args.k, pc.d, pc.q, pc.omega)
    lines = [f"fig4,algorithm,q,round,test_accuracy  "
             f"# target_bits={target:.0f}"]
    finals = {}
    for name, kind in ALGS.items():
        q = pc.q if kind == AggKind.CL_SIA else tune_q(kind, target, pc,
                                                       fed, args.device)
        sim = Simulator(pc, agg_config(kind, q=q), fed, local_lr=pc.lr,
                        device=args.device)
        out = sim.run(args.rounds, test_x=test.x, test_y=test.y,
                      eval_every=args.eval_every)
        for r, acc in out["accuracy"]:
            lines.append(f"fig4,{name},{q},{r},{acc:.4f}")
        finals[name] = out["accuracy"][-1][1]
    lines.append(f"# equal-bandwidth finals: "
                 f"{ {n: round(v, 3) for n, v in finals.items()} } "
                 f"(paper: CL-SIA best, SIA slowest)")
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
