"""Where the paper-shape level time goes: device time against host time.

At the paper's shape (K = 28 clients, d = 7850) every level kernel is one
tile per lane, and a level's time is mostly the host's: the Python
wrapper, its allocations, the ``ctypes`` call and the torch ops around
the launches. ``measure`` splits that time, on one tree of the port:

* each level kernel at W = 1 and W = 28 (d = 7850, the main path's
  variant): host µs per call (the enqueue, no synchronize), wall µs per
  call (back-to-back calls, then a synchronize), and device µs and device
  ops per call from ``torch.profiler`` (memsets included). Rows 1-4 of
  ``PERF.md``'s kernel table, and the resident forms where the tree has
  them; with ``--all`` rows 5-6 too and the scalar kernels (rows 7-11)
  on one row of d = 7850;
* one whole level of CL-SIA, SIA, RE-SIA and TC-SIA on the chain (W = 1)
  through ``algorithms.level_step``, under exact Top-Q and under
  threshold Top-Q (scan, 3 rounds of 64 candidates): device ops, device
  µs and host µs (TC-SIA with a lane-shared mask of Q_G ones);
* whole simulator rounds of the same kinds on the chain (K = 28, exact
  and threshold): ms per round (host clock after a synchronize), and
  device ops and busy ms per round from the profiler.

``split`` divides the resident kernels' device time (W = 1): the
select's with and without its radix passes (q = 78 against q = 0 and q =
d, which skip them), the search's against its rounds and its branch, and
both against d up to the resident limit.

Every line printed is one JSON object; ``--json`` also writes them as a
list. Needs a CUDA card; run from the repository root:

    python3 tools/torch_resident_level.py measure [--src SRC] [--json OUT]
        [--all] [--kernels-only]
    python3 tools/torch_resident_level.py split [--json OUT]

``--src`` points at another tree's ``src`` (say the parent commit's,
unpacked with ``git archive`` into the ignored ``build/``); that tree's
kernels build into its own ``build/``. Run the trees in turns on one
card (old, new, new, old) before comparing times; the device-op counts
do not depend on the turn.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
PAPER_D = 7850
LANES = (1, 28)
BRANCH, ROUNDS = 64, 3
CALLS = 200                 # back-to-back calls per host timing
PROFILED = 50               # calls under the profiler
SIM_ROUNDS = 10
KINDS = ("cl_sia", "sia", "re_sia", "tc_sia")
ALL = False


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(rows: list, **row):
    rows.append(row)
    print(json.dumps(row), flush=True)


def device_profile(fn, calls: int) -> tuple:
    """(device µs per call, device ops per call) of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    us = sum(getattr(e, "self_device_time_total", 0)
             or getattr(e, "self_cuda_time_total", 0) for e in events)
    return us / calls, sum(e.count for e in events) / calls


def host_times(fn, calls: int = CALLS) -> tuple:
    """(host µs per call, wall µs per call): the enqueue of ``calls``
    back-to-back calls, and the same up to a synchronize."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return host * 1e6 / calls, wall * 1e6 / calls


def level_inputs(w: int, d: int, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda: torch.randn((w, d), generator=gen, device="cuda")  # noqa
    x = dict(g=r(), e=0.3 * r(), gin=r(), weight=torch.ones(w, device="cuda"),
             tau=torch.full((w,), 1.0, device="cuda"),
             part=torch.ones(w, device="cuda"),
             valid=torch.ones(w, device="cuda"))
    x["mask"] = (torch.rand((w, d), generator=gen, device="cuda")
                 < 0.01).float()
    x["taus"] = torch.sort(torch.rand((w, BRANCH), generator=gen,
                                      device="cuda") * 3, dim=-1).values
    x["gm"] = torch.zeros((d,), device="cuda")
    x["gm"][:70] = 1.0
    return x


def kernel_calls(level, x: dict) -> dict:
    """The main path's variant of each level kernel on ``x``; with
    ``--all`` also the other level kernels (rows 5-6)."""
    calls = {
        "cl_fuse_level": lambda: level.cl_fuse_level_cuda(
            x["g"], x["e"], x["gin"], x["weight"], x["tau"], x["part"],
            x["valid"], None, x["mask"]),
        "sparsify_ef_level": lambda: level.sparsify_ef_level_cuda(
            x["g"], x["e"], x["mask"], x["weight"], x["tau"], x["valid"]),
        "chain_accum_level": lambda: level.chain_accum_level_cuda(
            x["gin"], x["g"], x["valid"]),
        "count_ge_fused_level": lambda: level.count_ge_fused_level_cuda(
            x["g"], x["e"], x["gin"], x["weight"], x["part"], x["taus"],
            include_gamma=True),
    }
    if ALL:
        from repro_torch.core import sparsify as sp
        hi = x["g"].abs().amax(-1) * sp._HI_SCALE
        tables = sp._hist_tables(torch.zeros_like(hi), hi, BRANCH)
        calls["hist_topq_level"] = lambda: level.hist_topq_level_cuda(
            x["g"], x["e"], x["gin"], x["weight"], x["part"], tables,
            include_gamma=True)
        calls["count_ge_level"] = lambda: level.count_ge_level_cuda(
            x["g"], x["taus"])
    if hasattr(level, "cl_fuse_select_level_cuda"):
        calls["cl_fuse_select_level"] = lambda: (
            level.cl_fuse_select_level_cuda(
                x["g"], x["e"], x["gin"], x["weight"], x["part"],
                x["valid"], q=78))
        calls["tau_search_fused_level"] = lambda: (
            level.tau_search_fused_level_cuda(
                x["g"], x["e"], x["gin"], x["weight"], x["part"], q=78,
                branch=BRANCH, rounds=ROUNDS, include_gamma=True))
    if hasattr(level, "ia_fuse_select_level_cuda"):
        # exact SIA; TC-SIA with a lane-shared mask and its q_local; SIA
        # given τ
        calls["ia_fuse_select_level"] = lambda: (
            level.ia_fuse_select_level_cuda(
                x["g"], x["e"], x["gin"], x["weight"], x["part"],
                x["valid"], kind="sia", q=78))
        calls["ia_fuse_select_level/tc_sia"] = lambda: (
            level.ia_fuse_select_level_cuda(
                x["g"], x["e"], x["gin"], x["weight"], x["part"],
                x["valid"], x["gm"], kind="tc_sia", q=8))
        calls["ia_fuse_select_level/tau"] = lambda: (
            level.ia_fuse_select_level_cuda(
                x["g"], x["e"], x["gin"], x["weight"], x["part"],
                x["valid"], kind="sia", tau=x["tau"]))
    return calls


def scalar_calls(x: dict) -> dict:
    """The scalar [d] kernels (rows 7-11) on row 0 of ``x``, the scalars
    as numbers."""
    from repro_torch.kernels import chain_accum, sparsify_ef, topq_threshold
    g, e, gin, mask = (x[k][0] for k in ("g", "e", "gin", "mask"))
    taus = x["taus"][0]
    return {
        "chain_accum": lambda: chain_accum.chain_accum_cuda(gin, g),
        "cl_fuse": lambda: chain_accum.cl_fuse_cuda(g, e, gin, 0.8, 1.0),
        "sparsify_ef": lambda: sparsify_ef.sparsify_ef_cuda(g, e, mask, 0.8,
                                                            1.0),
        "count_ge": lambda: topq_threshold.count_ge_cuda(g, taus),
        "count_ge_fused": lambda: topq_threshold.count_ge_fused_cuda(
            g, e, gin, 0.8, 1.0, taus, include_gamma=True),
    }


def paper_data():
    from repro_torch.configs import PAPER
    from repro_torch.data import make_synthetic_mnist, partition_iid

    k = PAPER.num_clients
    train = make_synthetic_mnist(0, k * 500, device="cuda")
    fed = partition_iid(train, k, torch.Generator().manual_seed(2))
    return PAPER, fed


def measure(args) -> list:
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import algorithms as alg
    from repro_torch.fed import Simulator
    from repro_torch.kernels import level

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    level.build()
    dev = card()
    emit(rows, what="tree", src=str(args.src), card=dev,
         resident=hasattr(level, "cl_fuse_select_level_cuda"),
         resident_ia=hasattr(level, "ia_fuse_select_level_cuda"))
    for w in LANES:
        x = level_inputs(w, PAPER_D, seed=w)
        calls = kernel_calls(level, x)
        if ALL and w == 1:
            calls.update(scalar_calls(x))
        for name, fn in calls.items():
            host_us, wall_us = host_times(fn)
            dev_us, ops = device_profile(fn, PROFILED)
            emit(rows, what="kernel", name=name, W=w, d=PAPER_D,
                 host_us=host_us, wall_us=wall_us, device_us=dev_us,
                 device_ops=ops, card=dev)
    if args.kernels_only:
        return rows

    pc, fed = paper_data()
    kw = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    forms = {"exact": {}, "threshold": dict(
        topq_impl="threshold", tau_impl="scan", hist_rounds=ROUNDS,
        hist_branch=BRANCH)}
    x = level_inputs(1, pc.d, seed=7)
    # the TCS mask of a round: Q_G ones (zeros for the other kinds)
    gm = torch.zeros((pc.d,), device="cuda")
    gm[:pc.q_global] = 1.0
    for kind in KINDS:
        for form, extra in forms.items():
            step = alg.level_step(alg.AggConfig(kind=kind, **kw, **extra))
            fn = lambda: step(x["g"], x["gin"], x["e"],  # noqa: E731
                              x["weight"], x["part"], gm)
            host_us, wall_us = host_times(fn, 50)
            dev_us, ops = device_profile(fn, 20)
            emit(rows, what="level", kind=kind, form=form, W=1, d=pc.d,
                 host_us=host_us, wall_us=wall_us, device_us=dev_us,
                 device_ops=ops, card=dev)
    for kind in KINDS:
        for form, extra in forms.items():
            sim = Simulator(pc, alg.AggConfig(kind=kind, **kw, **extra), fed,
                            device="cuda")
            sim.run(2, seed=0)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sim.run(SIM_ROUNDS, seed=0)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3 / SIM_ROUNDS)
            dev_us, ops = device_profile(lambda: sim.run(1, seed=0), 3)
            emit(rows, what="round", kind=kind, form=form,
                 topology="chain", K=pc.num_clients, d=pc.d,
                 ms_per_round=statistics.median(walls),
                 ms_range=[min(walls), max(walls)], device_ms=dev_us / 1e3,
                 device_ops=ops, card=dev)
    return rows


def split(args) -> list:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import level

    level.build()
    dev, rows = card(), []

    def device_us(fn):
        return device_profile(fn, PROFILED)[0]

    def select(x, q):
        return lambda: level.cl_fuse_select_level_cuda(
            x["g"], x["e"], x["gin"], x["weight"], x["part"], x["valid"],
            q=q)

    def search(x, rounds=ROUNDS, branch=BRANCH):
        return lambda: level.tau_search_fused_level_cuda(
            x["g"], x["e"], x["gin"], x["weight"], x["part"], q=78,
            branch=branch, rounds=rounds, include_gamma=True)

    x = level_inputs(1, PAPER_D, seed=1)
    for q in (0, 1, 78, PAPER_D - 1, PAPER_D):
        emit(rows, what="select", d=PAPER_D, q=q,
             device_us=device_us(select(x, q)), card=dev)
    for rounds in (1, 2, 3, 6):
        emit(rows, what="search", d=PAPER_D, rounds=rounds, branch=BRANCH,
             device_us=device_us(search(x, rounds=rounds)), card=dev)
    for branch in (8, 64, 512, 1024):
        emit(rows, what="search", d=PAPER_D, rounds=ROUNDS, branch=branch,
             device_us=device_us(search(x, branch=branch)), card=dev)
    for d in (1024, 4096, PAPER_D, 16384, level.RESIDENT_MAX_D):
        y = level_inputs(1, d, seed=2)
        emit(rows, what="by_d", d=d, select_us=device_us(select(y, 78)),
             search_us=device_us(search(y)), card=dev)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("measure", help="split paper-shape level time")
    m.add_argument("--src", default=str(ROOT / "src"))
    m.add_argument("--json", default=None)
    m.add_argument("--all", action="store_true",
                   help="every kernel of the table, not rows 1-4 alone")
    m.add_argument("--kernels-only", action="store_true",
                   help="the kernels' calls, not the levels and rounds")
    sp = sub.add_parser("split", help="the resident kernels' device time "
                        "against q, rounds, branch and d")
    sp.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_resident_level: needs a CUDA card", file=sys.stderr)
        return 2
    if args.cmd == "split":
        rows = split(args)
    else:
        global ALL
        ALL = args.all
        rows = measure(args)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
