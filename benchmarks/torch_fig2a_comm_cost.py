"""Paper Fig. 2a on the PyTorch/CUDA port: total transmitted data per
global iteration vs K (twin of ``fig2a_comm_cost.py``).

Measured from the simulator's exact §V bit accounting (averaged over
training rounds after the first four), plus the analytic curves (routing,
dense IA, Prop-2 bound) the paper plots alongside.

    python benchmarks/torch_fig2a_comm_cost.py [--device cpu] [--ks 4 8]
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


def measure(k: int, rounds: int = ROUNDS, device=None) -> dict:
    pc = dataclasses.replace(PAPER, num_clients=k)
    fed, _ = paper_data(k, per_client=60, device=device)
    out = {}
    for name, kind in ALGS.items():
        sim = Simulator(pc, agg_config(kind), fed, local_lr=pc.lr,
                        device=device)
        res = sim.run(rounds)
        # skip warmup rounds (support still correlating)
        out[name] = sum(res["bits"][WARMUP:]) / len(res["bits"][WARMUP:])
    ql = max(1, round(0.1 * pc.q))
    out["IA (dense)"] = cc.dense_ia_bits(k, pc.d, pc.omega)
    out["routing (dense)"] = cc.routing_dense_bits(k, pc.d, pc.omega)
    out["routing (sparse)"] = cc.routing_sparse_bits(k, pc.d, pc.q,
                                                     pc.omega)
    out["TC-SIA Prop2 bound"] = cc.tc_sia_bits_bound(k, pc.d, pc.q - ql, ql,
                                                     pc.omega)
    return out


def main(argv=None) -> list[str]:
    p = parser(__doc__)
    p.add_argument("--ks", type=int, nargs="+", default=list(KS))
    p.add_argument("--rounds", type=int, default=ROUNDS)
    args = p.parse_args(argv)
    print(device_line(args.device))
    lines = ["fig2a,K,algorithm,bits_per_iteration"]
    results = {}
    for k in args.ks:
        results[k] = measure(k, args.rounds, args.device)
        for name, bits in results[k].items():
            lines.append(f"fig2a,{k},{name},{bits:.0f}")
    print("\n".join(lines))
    # headline check (paper §VI): CL-SIA is K·Q·(ω+⌈log2 d⌉) exactly
    k = args.ks[-1]
    got = results[k]["CL-SIA"]
    want = cc.cl_sia_bits(k, PAPER.d, PAPER.q, PAPER.omega)
    lines.append(f"# CL-SIA@K={k}: measured {got:.0f} vs closed-form "
                 f"{want:.0f} ({'OK' if abs(got - want) < 1 else 'MISMATCH'})")
    print(lines[-1])
    return lines


if __name__ == "__main__":
    main()
