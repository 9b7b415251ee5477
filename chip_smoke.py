"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine with
a CUDA card and the CUDA toolkit (nvcc). It needs no network and one card.

Phases (any failure exits non-zero and prints no result):

1. device — the card's name and power limit, the torch/CUDA versions, and
   the build of the level kernels from ``src/repro_torch/kernels/csrc``
   (nvcc's register and shared-memory report);
2. kernels — every level kernel over its variants (global mask none /
   [d] / [W, d], mask_in on/off, pinned ‖e′‖² on/off, a ``valid == 0``
   lane, a ``p == 0`` lane, a τ = +inf lane) at the paper's shapes
   (W = 1 and 28, d = 7850) and a large ragged one (W = 8,
   d = 2**23 + 125), each output held bit for bit against the kernel's
   plain PyTorch version run on the CPU on the same inputs; then each
   kernel timed with CUDA events beside its plain version on the card and
   its device-memory bound;
3. main path — the paper simulator (K = 28, d = 7850, ``kernel_mode=
   "auto"``) on the card, after one warm-up round of each algorithm, for
   20 rounds of each algorithm on the chain and of each fused algorithm on
   a star tree, with launch counts read around those runs; the loss must
   fall, CL-SIA's bits must equal the §V closed form every round on both
   topologies, and a short run must agree with the same run on the CPU;
   then torch.profiler reads the device-busy share of a few rounds.

The last lines are a JSON object of per-kernel numbers, the card's
``name, power.limit`` as nvidia-smi prints them, and the result object.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
LARGE = (8, 2 ** 23 + 125)
PAPER_SHAPES = [(1, 7850), (28, 7850)]
ROUNDS = 20
SEED = 0


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_inputs(w: int, d: int, seed: int) -> dict:
    """numpy inputs for one level; lanes 1 / 2 / last are the straggler,
    padding and τ = +inf lanes where W allows."""
    rng = np.random.default_rng(seed)
    f = lambda: rng.standard_normal((w, d), dtype=np.float32)
    x = dict(g=f(), e=f() * np.float32(0.3), gin=f(),
             weight=rng.uniform(0.2, 2.0, w).astype(np.float32),
             tau=np.full(w, 1.0, np.float32),
             part=np.ones(w, np.float32), valid=np.ones(w, np.float32),
             gm=(rng.random(d, dtype=np.float32) < 0.1).astype(np.float32),
             gmw=(rng.random((w, d), dtype=np.float32) < 0.1).astype(
                 np.float32),
             mask=(rng.random((w, d), dtype=np.float32) < 0.01).astype(
                 np.float32))
    x["gin"] *= rng.random((w, d), dtype=np.float32) < 0.3
    if w > 1:
        x["part"][1] = 0.0
        x["tau"][-1] = np.inf
    if w > 2:
        x["valid"][2] = 0.0
    return x


def variants():
    """(kernel name, options) for every variant of each kernel."""
    for gm in (None, "gm", "gmw"):
        for mask in (False, True):
            for err in (False, True):
                yield "cl_fuse_level", dict(gm=gm, mask=mask, err=err)
    for mask in (False, True):
        for err in (False, True):
            yield "sparsify_ef_level", dict(gm=None, mask=mask, err=err)
    for gm in (None, "gm", "gmw"):
        yield "chain_accum_level", dict(gm=gm, mask=False, err=False)


def call(fns, name: str, t: dict, opt: dict):
    """Call kernel ``name`` (from ``fns``: the CUDA wrappers or the plain
    versions) on tensors ``t`` with variant ``opt``."""
    gm = t[opt["gm"]] if opt["gm"] else None
    mask = t["mask"] if opt["mask"] else None
    if name == "cl_fuse_level":
        return fns[name](t["g"], t["e"], t["gin"], t["weight"], t["tau"],
                         t["part"], t["valid"], gm, mask,
                         with_err=opt["err"])
    if name == "sparsify_ef_level":
        return fns[name](t["g"], t["e"], mask, t["weight"], t["tau"],
                         t["valid"], with_err=opt["err"])
    return fns[name](t["gin"], t["g"], t["valid"], gm)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.cpu(), b.cpu()
    wide = torch.float64 if a.dtype == torch.float32 else torch.int64
    return float((a.to(wide) - b.to(wide)).abs().max())


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def kernel_bytes(name: str, w: int, d: int) -> int:
    """Bytes the timed variant must move: each input read once, each
    output written once (per-lane scalars and counts included)."""
    if name == "cl_fuse_level":        # g,e,γ_in,mask_in,gm[d] → γ,e′
        return (6 * w * d + d) * 4 + 4 * w * 4 + 2 * w * 4
    if name == "sparsify_ef_level":    # g,e,mask_in → ḡ,e′
        return 5 * w * d * 4 + 3 * w * 4 + w * 4
    return (3 * w * d + d) * 4 + w * 4 + 2 * w * 4   # γ_in,ḡ,gm[d] → γ


TIMED = {"cl_fuse_level": dict(gm="gm", mask=True, err=False),
         "sparsify_ef_level": dict(gm=None, mask=True, err=False),
         "chain_accum_level": dict(gm="gm", mask=False, err=False)}


def cuda_time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernels(level, ref) -> dict:
    cuda_fns = {"cl_fuse_level": level.cl_fuse_level_cuda,
                "sparsify_ef_level": level.sparsify_ef_level_cuda,
                "chain_accum_level": level.chain_accum_level_cuda}
    plain_fns = {"cl_fuse_level": ref.ref_cl_fuse_level,
                 "sparsify_ef_level": ref.ref_sparsify_ef_level,
                 "chain_accum_level": ref.ref_chain_accum_level}
    report = {n: dict(max_abs_err=0.0, max_abs_err_plain_on_card=0.0,
                      checked=0, shapes=[]) for n in cuda_fns}
    dev = torch.device("cuda")
    for si, (w, d) in enumerate(PAPER_SHAPES + [LARGE]):
        t0 = time.perf_counter()
        x = make_inputs(w, d, SEED + si)
        cpu = {k: torch.from_numpy(v) for k, v in x.items()}
        gpu = {k: v.to(dev) for k, v in cpu.items()}
        for name, opt in variants():
            got = call(cuda_fns, name, gpu, opt)
            torch.cuda.synchronize()
            want = call(plain_fns, name, cpu, opt)
            on_card = call(plain_fns, name, gpu, opt)
            r = report[name]
            for a, b, c in zip(want, got, on_card):
                r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(a, b))
                r["max_abs_err_plain_on_card"] = max(
                    r["max_abs_err_plain_on_card"], max_abs_diff(c, b))
                if not bitwise_equal(a, b):
                    raise SystemExit(
                        f"FAIL {name} {opt} at W={w} d={d}: kernel differs "
                        f"from its plain version on the CPU "
                        f"(max |diff| {max_abs_diff(a, b)})")
            r["checked"] += 1
        log(f"[kernels] W={w} d={d}: all variants bitwise equal to the "
            f"plain CPU versions ({time.perf_counter() - t0:.1f} s)")
        # timing: every lane live, the main path's variant of each kernel
        gpu["valid"].fill_(1.0)
        gpu["part"].fill_(1.0)
        big = w * d > 10 ** 7
        for name, opt in TIMED.items():
            ms = cuda_time_ms(lambda: call(cuda_fns, name, gpu, opt),
                              20 if big else 200)
            plain_ms = cuda_time_ms(lambda: call(plain_fns, name, gpu, opt),
                                    5 if big else 50)
            bound_ms = kernel_bytes(name, w, d) / HBM_BYTES_PER_S * 1e3
            report[name]["shapes"].append(dict(
                W=w, d=d, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_share=bound_ms / ms))
            log(f"[time] {name} W={w} d={d}: kernel {ms:.4f} ms, plain "
                f"on card {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({100 * bound_ms / ms:.1f}% of bound)")
        del cpu, gpu
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def main_path(level) -> tuple:
    from repro_torch.configs import PAPER
    from repro_torch.core import comm_cost as cc
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.data import make_synthetic_mnist, partition_iid
    from repro_torch.fed import Simulator
    from repro_torch.topo import star_tree

    pc = PAPER
    k = pc.num_clients
    train = make_synthetic_mnist(SEED, k * 500, device="cuda")
    test = make_synthetic_mnist(SEED + 1, 2000, device="cuda")
    fed = partition_iid(train, k, torch.Generator().manual_seed(SEED + 2))
    kw = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    kinds = [AggKind.SIA, AggKind.RE_SIA, AggKind.CL_SIA, AggKind.TC_SIA,
             AggKind.CL_TC_SIA, AggKind.DENSE_IA]
    runs = [(kind, "chain", None) for kind in kinds]
    runs += [(kind, "star", star_tree(k)) for kind in kinds
             if kind != AggKind.DENSE_IA]
    sims = {kind: Simulator(pc, AggConfig(kind=kind, **kw), fed,
                            device="cuda") for kind in kinds}
    results = {}

    # one untimed round of each first: the first use of each CUDA op
    # (sorts, cuBLAS, torch.func) costs seconds, once per process
    t0 = time.perf_counter()
    for sim in sims.values():
        sim.run(1, seed=SEED)
    torch.cuda.synchronize()
    log(f"[main] warm-up, one round of each algorithm: "
        f"{time.perf_counter() - t0:.1f} s")

    level.reset_launch_counts()
    torch.cuda.synchronize()
    for kind, topo_name, topo in runs:
        t0 = time.perf_counter()
        out = sims[kind].run(ROUNDS, seed=SEED, topology=topo,
                             test_x=test.x, test_y=test.y,
                             eval_every=ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[(kind, topo_name)] = out
        log(f"[main] {kind.value:9s} {topo_name:5s}: loss "
            f"{out['loss'][0]:.4f} -> {out['loss'][-1]:.4f}, acc "
            f"{out['accuracy'][-1][1]:.3f}, bits/round "
            f"{out['bits'][-1]:.0f}, {1e3 * wall / ROUNDS:.2f} ms/round "
            f"(host clock, synchronized)")
    launches = {fn.__name__.replace("_cuda", ""): fn.launches
                for fn in level.KERNELS}
    log(f"[main] kernel launches over the main-path runs: {launches}")

    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"FAIL {name} was never launched on the "
                             f"main path")
    for (kind, topo_name), out in results.items():
        if not all(math.isfinite(v) for v in out["loss"]):
            raise SystemExit(f"FAIL {kind.value} {topo_name}: loss not "
                             f"finite")
        if not out["loss"][-1] < out["loss"][0]:
            raise SystemExit(f"FAIL {kind.value} {topo_name}: loss did not "
                             f"fall ({out['loss'][0]} -> {out['loss'][-1]})")
        state = out["state"]
        if (state.flat_w.shape != (pc.d,) or state.ef.shape != (k, pc.d)
                or not bool(torch.isfinite(state.flat_w).all())):
            raise SystemExit(f"FAIL {kind.value} {topo_name}: bad state")
    expect = cc.cl_sia_bits(k, pc.d, pc.q)
    for topo_name in ("chain", "star"):
        bits = results[(AggKind.CL_SIA, topo_name)]["bits"]
        if any(b != expect for b in bits):
            raise SystemExit(f"FAIL CL-SIA bits on the {topo_name} differ "
                             f"from the closed form {expect}: {bits}")
    if (results[(AggKind.CL_SIA, "chain")]["bits"]
            != results[(AggKind.CL_SIA, "star")]["bits"]):
        raise SystemExit("FAIL CL-SIA bits differ between chain and star")
    log(f"[main] CL-SIA bits = closed form {expect:.0f} in every round on "
        f"chain and star")

    # the same short run on the CPU (plain versions) must agree: losses to
    # rtol 1e-4 (the gradients' products sum in another order on the
    # card), the CL algorithms' bits exactly (constant per hop)
    for kind in (AggKind.SIA, AggKind.CL_SIA, AggKind.TC_SIA,
                 AggKind.CL_TC_SIA):
        sim_cpu = Simulator(pc, AggConfig(kind=kind, **kw), fed,
                            device="cpu")
        a = sims[kind].run(3, seed=SEED)
        b = sim_cpu.run(3, seed=SEED)
        rel = max(abs(u - v) / abs(v) for u, v in zip(a["loss"], b["loss"]))
        same_bits = a["bits"] == b["bits"]
        if rel > 1e-4 or (kind in (AggKind.CL_SIA, AggKind.CL_TC_SIA)
                          and not same_bits):
            raise SystemExit(f"FAIL {kind.value}: card and CPU runs differ "
                             f"(loss rel {rel:.2e}, bits {a['bits']} vs "
                             f"{b['bits']})")
        log(f"[main] {kind.value}: 3 rounds on the card vs the CPU: loss "
            f"max rel diff {rel:.2e}, bits equal: {same_bits}")
    for kind in (AggKind.CL_SIA, AggKind.SIA):
        for topo_name, topo in (("chain", None), ("star", star_tree(k))):
            profile_rounds(sims[kind], f"{kind.value} {topo_name}", topo)
    return launches


def profile_rounds(sim, label: str, topology, rounds: int = 3):
    """Device busy time and device-op count over a few rounds, from
    torch.profiler (its own overhead inflates the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    sim.run(1, topology=topology)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(rounds, seed=SEED, topology=topology)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(getattr(e, "self_device_time_total", 0) or
                  getattr(e, "self_cuda_time_total", 0)
                  for e in events) / 1e3 / rounds
    ops = sum(e.count for e in events) / rounds
    top = sorted(events, key=lambda e: -(getattr(
        e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)))[:4]
    log(f"[profile] {label}: {wall_ms:.2f} ms/round under the profiler, "
        f"device busy {busy_ms:.3f} ms/round ({100 * busy_ms / wall_ms:.1f}"
        f"%), {ops:.0f} device ops/round; top: "
        + ", ".join(e.key[:40] for e in top))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import level, ref

    # full-f32 products on the card, as in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_log = level.build()
    log(f"[build] {level.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("[ptxas]", line.strip())

    report = check_kernels(level, ref)
    launches = main_path(level)

    source = "src/repro_torch/kernels/csrc/level.cu"
    replaces = {"cl_fuse_level": "src/repro/kernels/level.py:395",
                "sparsify_ef_level": "src/repro/kernels/level.py:197",
                "chain_accum_level": "src/repro/kernels/level.py:282"}
    kernels = []
    for name, r in report.items():
        large = r["shapes"][-1]
        kernels.append(dict(
            name=name, route="cuda", source=source,
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=large["ms"],
            plain_ms=large["plain_ms"], bound_ms=large["bound_ms"],
            bound_by="bytes", library_ms=None,
            max_abs_err_plain_on_card=r["max_abs_err_plain_on_card"],
            variants_checked=r["checked"], shapes=r["shapes"]))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
