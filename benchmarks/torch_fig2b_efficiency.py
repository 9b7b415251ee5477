"""Paper Fig. 2b on the PyTorch/CUDA port: normalized communication
efficiency vs K (twin of ``fig2b_efficiency.py``).

Total transmitted data divided by the size of one (sparse) gradient
transmission. The paper's headline: CL-SIA / CL-TC-SIA sit on the dense-IA
line (K transmissions) while SIA/RE-SIA drift toward conventional
routing's (K²+K)/2.

    python benchmarks/torch_fig2b_efficiency.py [--device cpu] [--ks 4 8]
"""

from __future__ import annotations

import dataclasses

from torch_common import ALGS, PAPER, agg_config, device_line, paper_data, \
    parser

from repro_torch.core import comm_cost as cc
from repro_torch.fed import Simulator

KS = (4, 8, 16, 28)
ROUNDS = 12
WARMUP = 4


def main(argv=None) -> list[str]:
    p = parser(__doc__)
    p.add_argument("--ks", type=int, nargs="+", default=list(KS))
    p.add_argument("--rounds", type=int, default=ROUNDS)
    args = p.parse_args(argv)
    print(device_line(args.device))
    lines = ["fig2b,K,algorithm,normalized_transmissions"]
    for k in args.ks:
        pc = dataclasses.replace(PAPER, num_clients=k)
        fed, _ = paper_data(k, per_client=60, device=args.device)
        for name, kind in ALGS.items():
            sim = Simulator(pc, agg_config(kind), fed, local_lr=pc.lr,
                            device=args.device)
            res = sim.run(args.rounds)
            bits = sum(res["bits"][WARMUP:]) / len(res["bits"][WARMUP:])
            norm = cc.normalized_efficiency(bits, pc.d, pc.q, pc.omega)
            lines.append(f"fig2b,{k},{name},{norm:.2f}")
        lines.append(f"fig2b,{k},IA (no sparsification),{k}")
        lines.append(f"fig2b,{k},routing,{(k * k + k) / 2:.1f}")
    # headline: CL-SIA ratio to K is 1.0 (full IA efficiency)
    k = args.ks[-1]
    last = [ln for ln in lines if ln.startswith(f"fig2b,{k},CL-SIA,")][0]
    lines.append(f"# CL-SIA normalized/K = "
                 f"{float(last.split(',')[-1]) / k:.3f} (paper: 1.0)")
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
