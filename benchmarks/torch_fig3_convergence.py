"""Paper Fig. 3 on the PyTorch/CUDA port: test accuracy vs iteration,
fixed Q = 78, K = 28 (twin of ``fig3_convergence.py``).

Expected qualitative result (paper §VI): SIA/RE-SIA best (most data
sent), CL-SIA and TC-SIA only slightly worse, CL-TC-SIA severely impaired.

    python benchmarks/torch_fig3_convergence.py [--device cpu] [--k 6]
"""

from __future__ import annotations

import dataclasses

from torch_common import ALGS, PAPER, agg_config, device_line, paper_data, \
    parser

from repro_torch.fed import Simulator

ROUNDS = 150
EVAL_EVERY = 25


def main(argv=None) -> list[str]:
    p = parser(__doc__)
    p.add_argument("--k", type=int, default=PAPER.num_clients)
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--eval-every", type=int, default=EVAL_EVERY)
    args = p.parse_args(argv)
    print(device_line(args.device))
    pc = dataclasses.replace(PAPER, num_clients=args.k)
    fed, test = paper_data(args.k, per_client=120, device=args.device)
    lines = ["fig3,algorithm,round,test_accuracy"]
    finals = {}
    for name, kind in ALGS.items():
        sim = Simulator(pc, agg_config(kind), fed, local_lr=pc.lr,
                        device=args.device)
        out = sim.run(args.rounds, test_x=test.x, test_y=test.y,
                      eval_every=args.eval_every)
        for r, acc in out["accuracy"]:
            lines.append(f"fig3,{name},{r},{acc:.4f}")
        finals[name] = out["accuracy"][-1][1]
    order = sorted(finals, key=finals.get, reverse=True)
    lines.append(f"# final-accuracy order: {order} (paper: CL-TC-SIA last)")
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
