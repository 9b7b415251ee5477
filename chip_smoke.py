"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine with
a CUDA card and the CUDA toolkit (nvcc). It needs no network and one card.

Phases (any failure exits non-zero and prints no result):

1. device — the card's name and power limit, the torch/CUDA versions, and
   the build of the kernels from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, all started together; nvcc's register and
   shared-memory report);
2. kernels — every level kernel over its variants (global mask none /
   [d] / [W, d], mask_in on/off, pinned ‖e′‖² on/off, a ``valid == 0``
   lane, a ``p == 0`` lane, a τ = +inf lane) and every τ-search kernel
   over its variants (γ_in on/off × the three global-mask forms, a
   ``p == 0`` lane, the histogram at branch 64 and at a branch past
   shared memory, magnitudes on the histogram's bin edges and NaN, ±inf,
   ±0 and subnormal magnitudes at both branches, taus in any order for
   ``count_ge_level``, and ``count_ge_level`` on five lanes whose rank
   tables cover other ranges — all taus ≤ 0; ties, ±inf and NaN; all
   equal; subnormals to 1e30; a first scan round — with each lane's rows
   on its table's edges, B = 1, 64 and 4095, float32 and bfloat16 rows, at
   d = 2**20 + 77) at the paper's shapes (W = 1 and 28,
   d = 7850) and a large ragged one (W = 8, d = 2**23 + 125; one variant
   per τ-search kernel there), each output held bit for bit against the
   kernel's plain PyTorch version run on the CPU on the same inputs; then
   each kernel timed with CUDA events beside its plain version on the card
   and its bound;
3. main path, exact Top-Q — the paper simulator (K = 28, d = 7850,
   ``kernel_mode="auto"``) on the card, after one warm-up round of each
   algorithm, for 20 rounds of each algorithm on the chain and of each
   fused algorithm on a star tree, with launch counts read around those
   runs; the loss must fall, CL-SIA's bits must equal the §V closed form
   every round on both topologies, and a short run must agree with the
   same run on the CPU; then torch.profiler reads the device-busy share of
   a few rounds;
4. main path, threshold Top-Q — the same simulator with
   ``topq_impl="threshold"`` for each fused algorithm on the chain and the
   star, under ``tau_impl="scan"`` (3 rounds of 64 candidates) and
   ``"hist"`` (2 rounds), 20 rounds each after a warm-up, with launch
   counts read around the runs and held to the prediction; hist must equal
   the scan at 2 rounds bit for bit (bits and loss per round), 3 rounds on
   the card fed the CPU run's gradients must give the CPU run's τ, count
   integers, model and bits bit for bit (loss to rtol 1e-4), the loss must
   fall, and ``threshold_for_topq(count_fn=count_ge_level)`` on the card
   must give the default search's τ; torch.profiler reads the device-busy
   share of a threshold round;
5. the scalar kernel API — the five scalar ``[d]`` kernels, checked in
   phase 2 over their variants (float32 and bfloat16, mask_in on/off,
   include_gamma on/off, shuffled taus with −1, 0 and +inf, the scalars as
   numbers and as tensors on the card) at d = 7850, 10**6 and 2**26 + 125
   bit for bit against their plain versions on the CPU and on the card,
   and timed, and ``count_ge`` on the bucket edges of its rank table with
   B = 1, 64 and 4095 (4096 refused); then driven through the ``ops`` entries with launch counts
   read around the run: the 1-D τ search ``threshold_for_topq(x, q,
   count_fn=ops.count_ge)`` at d = 10**6 for three q, and a 28-node chain
   of scalar node steps at d = 7850 for SIA (``count_ge_fused``,
   ``sparsify_ef``, ``chain_accum``) and CL-SIA (``count_ge_fused``,
   ``cl_fuse``), τ left on the card; τ, γ, the EF rows and nnz must equal
   the same run on the CPU bit for bit.

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
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
LARGE = (8, 2 ** 23 + 125)
PAPER_SHAPES = [(1, 7850), (28, 7850)]
ROUNDS = 20
SEED = 0
BRANCH = 64                        # candidates per τ-search round
WIDE_BRANCH = 256                  # a histogram past shared memory
THRESHOLD = {"scan": dict(tau_impl="scan", hist_rounds=3),
             "hist": dict(tau_impl="hist", hist_rounds=2)}
# the scalar [d] kernels: the paper's d, bench_kernels.py's default, and
# the level phases' element count W·d = 8 × 2**23 with a ragged tail
SCALAR_SHAPES = [7850, 1_000_000, 2 ** 26 + 125]
SCALAR_DTYPES = (torch.float32, torch.bfloat16)
SEARCH_D = 1_000_000               # the 1-D τ search counting with count_ge
SEARCH_QS = (10, 500, 5000)
EDGE_TAUS = (1, 64, 4095)          # count_ge on its rank table's edges
LANES_D = 2 ** 20 + 77             # count_ge_level on its special lanes


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
    wide = torch.float64 if a.is_floating_point() else torch.int64
    return float((a.to(wide) - b.to(wide)).abs().max())


BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (zeros' signs included)."""
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in BITS:
        a, b = a.view(BITS[a.dtype]), b.view(BITS[b.dtype])
    return torch.equal(a, b)


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
# phase 2 (continued): the τ-search kernels
# ---------------------------------------------------------------------------

def tau_variants(large: bool):
    """(kernel name, options) for the τ-search kernels; one variant each
    at the large shape, where the plain versions on the CPU take longest."""
    if large:
        yield "count_ge_fused_level", dict(gamma=True, gm="gm")
        yield "hist_topq_level", dict(gamma=True, gm="gm", branch=BRANCH)
        yield "count_ge_level", dict()
        return
    for gm in (None, "gm", "gmw"):
        for gamma in (False, True):
            yield "count_ge_fused_level", dict(gamma=gamma, gm=gm)
            for branch in (BRANCH, WIDE_BRANCH):
                yield "hist_topq_level", dict(gamma=gamma, gm=gm,
                                              branch=branch)
    for branch in (BRANCH, WIDE_BRANCH):
        yield "hist_topq_level", dict(gamma=False, gm=None, branch=branch,
                                      edges=True)
        yield "hist_topq_level", dict(gamma=False, gm=None, branch=branch,
                                      specials=True)
    yield "count_ge_level", dict()


def tau_tables(sp, ref, t: dict, opt: dict, branch: int):
    """The bracket tables of a first search round over the variant's
    operand (computed on the CPU; both sides get the same tables)."""
    op = ref.fused_operand(t["g"], t["e"], t["gin"], t["weight"],
                           t["part"], t[opt["gm"]] if opt["gm"] else None,
                           include_gamma=opt["gamma"])
    hi = torch.clamp(op.abs().amax(-1), min=1e-30) * sp._HI_SCALE
    return sp._hist_tables(torch.zeros_like(hi), hi, branch)


def edge_inputs(sp, ref, cpu: dict, branch: int, specials: bool) -> tuple:
    """→ (inputs, tables): operand = g exactly (w = 1, e = 0), with g on
    the bin edges of ``tables`` (the FMA-rounded round-2 candidates, tau1
    and the bracket tops) or, with ``specials``, NaN, ±inf, ±0 and
    subnormals in a tenth of lane 0 and an all-zero last lane (its tables
    take the zero-width floor)."""
    w, d = cpu["g"].shape
    plain = dict(cpu, e=torch.zeros_like(cpu["g"]),
                 weight=torch.ones(w), part=torch.ones(w))
    if specials:
        g = cpu["g"].clone()
        if w > 1:
            g[-1] = 0.0
        plain["g"] = g
    tables = tau_tables(sp, ref, plain, dict(gm=None, gamma=False), branch)
    if specials:
        g[0, :d // 10] = ref.special_magnitudes(d // 10, seed=SEED)
    else:
        g = ref.hist_edge_magnitudes(tables, d, seed=SEED)
    return dict(plain, g=g), tables


def call_tau(fns, name: str, t: dict, opt: dict, aux: dict):
    """Call τ-search kernel ``name`` (CUDA wrapper or plain version) on
    tensors ``t``; ``aux`` holds its taus or tables on the same device."""
    if name == "count_ge_level":
        return (fns[name](t["g"], aux["taus_any"]),)
    gm = t[opt["gm"]] if opt["gm"] else None
    operand = (t["g"], t["e"], t["gin"], t["weight"], t["part"])
    if name == "count_ge_fused_level":
        return (fns[name](*operand, aux["tables"][0], gm,
                          include_gamma=opt["gamma"]),)
    return fns[name](*operand, aux["tables"], gm, include_gamma=opt["gamma"])


def tau_cost(name: str, w: int, d: int, n: int) -> tuple:
    """(bytes, f32 operations) the timed variant must spend: each input
    read once, each output written once; per element the operand's flops
    and the binary searches' compares (and candidate fmas), or for
    ``count_ge_level`` the table lookup (|x|, its bucket, one compare)."""
    search = math.ceil(math.log2(n + 1))
    if name == "count_ge_level":
        return (w * d + 2 * w * n) * 4, w * d * 3
    operand = (3 * w * d + d + 2 * w) * 4          # g, e, γ_in, gm[d], w, p
    flops = 6 + search                              # 2 fma, 1−m, ·, |·|
    if name == "count_ge_fused_level":
        return operand + 2 * w * n * 4, w * d * flops
    nb = n + 1
    tables = w * (n + 3 * nb) * 4
    outputs = w * (nb * nb + nb) * 4
    return operand + tables + outputs, w * d * (flops + 3 * search + 1)


TAU_TIMED = {"count_ge_fused_level": dict(gamma=True, gm="gm"),
             "hist_topq_level": dict(gamma=True, gm="gm", branch=BRANCH),
             "count_ge_level": dict()}


def check_tau_kernels(level, ref, sp) -> dict:
    cuda_fns = {"count_ge_fused_level": level.count_ge_fused_level_cuda,
                "hist_topq_level": level.hist_topq_level_cuda,
                "count_ge_level": level.count_ge_level_cuda}
    plain_fns = {"count_ge_fused_level": ref.ref_count_ge_fused_level,
                 "hist_topq_level": ref.ref_hist_topq_level,
                 "count_ge_level": ref.ref_count_ge_level}
    report = {n: dict(max_abs_err=0.0, max_abs_err_plain_on_card=0.0,
                      checked=0, shapes=[]) for n in cuda_fns}
    shared_max = level.hist_shared_max_branch()
    if not BRANCH <= shared_max < WIDE_BRANCH:
        raise SystemExit(f"FAIL the histogram at branch {WIDE_BRANCH} "
                         f"would not take the global-atomics variant "
                         f"(shared memory holds up to {shared_max})")
    log(f"[tau] histogram in shared memory up to branch {shared_max}; "
        f"branch {WIDE_BRANCH} takes the global-atomics variant")
    dev = torch.device("cuda")
    for si, (w, d) in enumerate(PAPER_SHAPES + [LARGE]):
        t0 = time.perf_counter()
        large = (w, d) == LARGE
        x = make_inputs(w, d, SEED + 10 + si)
        cpu = {k: torch.from_numpy(v) for k, v in x.items()}
        rng = np.random.default_rng(SEED + si)
        taus = np.abs(rng.standard_normal((w, BRANCH))).astype(np.float32)
        taus[:, 5] = taus[:, 9]
        taus[:, 7], taus[:, 8], taus[:, 11] = np.inf, -np.inf, 0.0
        for name, opt in tau_variants(large):
            aux = {"taus_any": torch.from_numpy(taus)}
            if opt.get("edges") or opt.get("specials"):
                inp, aux["tables"] = edge_inputs(sp, ref, cpu, opt["branch"],
                                                 opt.get("specials", False))
            else:
                inp = cpu
                if name != "count_ge_level":
                    aux["tables"] = tau_tables(sp, ref, inp, opt,
                                               opt.get("branch", BRANCH))
            gpu = {k: v.to(dev) for k, v in inp.items()}
            aux_gpu = {k: (tuple(u.to(dev) for u in v)
                           if isinstance(v, tuple) else v.to(dev))
                       for k, v in aux.items()}
            got = call_tau(cuda_fns, name, gpu, opt, aux_gpu)
            torch.cuda.synchronize()
            want = call_tau(plain_fns, name, inp, opt, aux)
            on_card = call_tau(plain_fns, name, gpu, opt, aux_gpu)
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
            del gpu, aux_gpu
        log(f"[kernels] W={w} d={d}: the τ-search kernels equal their plain "
            f"CPU versions integer for integer "
            f"({time.perf_counter() - t0:.1f} s)")
        gpu = {k: v.to(dev) for k, v in cpu.items()}
        gpu["part"].fill_(1.0)
        for name, opt in TAU_TIMED.items():
            n = BRANCH
            aux = {"taus_any": torch.from_numpy(taus).to(dev)}
            if name != "count_ge_level":
                aux["tables"] = tuple(u.to(dev) for u in tau_tables(
                    sp, ref, cpu, opt, n))
            ms = cuda_time_ms(lambda: call_tau(cuda_fns, name, gpu, opt,
                                               aux), 20 if large else 200)
            plain_ms = cuda_time_ms(lambda: call_tau(plain_fns, name, gpu,
                                                     opt, aux),
                                    5 if large else 50)
            nbytes, ops = tau_cost(name, w, d, n)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            report[name]["shapes"].append(dict(
                W=w, d=d, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_share=bound_ms / ms))
            log(f"[time] {name} W={w} d={d} B={n}: kernel {ms:.4f} ms, "
                f"plain on card {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({100 * bound_ms / ms:.1f}% of bound)")
        # count_ge_level on bfloat16 rows (read as such, half the bytes)
        x16 = gpu["g"].to(torch.bfloat16)
        taus = torch.from_numpy(taus).to(dev)
        ms = cuda_time_ms(lambda: cuda_fns["count_ge_level"](x16, taus),
                          20 if large else 200)
        plain_ms = cuda_time_ms(lambda: plain_fns["count_ge_level"](x16,
                                                                    taus),
                                5 if large else 50)
        nbytes, ops = tau_cost("count_ge_level", w, d, BRANCH)
        nbytes -= w * d * 2
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        report["count_ge_level"]["shapes"].append(dict(
            W=w, d=d, dtype="bfloat16", ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_share=bound_ms / ms))
        log(f"[time] count_ge_level W={w} d={d} B={BRANCH} bfloat16: kernel "
            f"{ms:.4f} ms, plain on card {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of bound)")
        del cpu, gpu, x16
        torch.cuda.empty_cache()
    check_count_ge_level_lanes(cuda_fns["count_ge_level"], ref,
                               report["count_ge_level"])
    return report


def check_count_ge_level_lanes(count_ge_level, ref, r: dict):
    """count_ge_level at d = LANES_D on five lanes whose rank tables cover
    other ranges (``ref.count_level_edge_taus``), each lane's rows on its
    table's edges and its taus with NaN, ±inf, ±0 and subnormals in lane 0;
    B = 1, 64 and 4095 (MAX_TAUS); float32 and bfloat16 rows; the operand
    at an odd offset of a larger buffer; bit for bit against the plain
    version on the CPU. 4096 taus must be refused."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for n in EDGE_TAUS:
        taus = ref.count_level_edge_taus(n, seed=SEED + n)
        w, d = taus.shape[0], LANES_D
        x = ref.count_level_edge_rows(taus, d, seed=SEED + n)
        for dt in SCALAR_DTYPES:
            rows = x.to(dt)
            flat = torch.zeros(w * d + 1, dtype=dt, device=dev)
            flat[1:] = rows.reshape(-1).to(dev)
            want = ref.ref_count_ge_level(rows, taus)
            got = count_ge_level(flat[1:].view(w, d), taus.to(dev))
            torch.cuda.synchronize()
            r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(want, got))
            if not bitwise_equal(want, got):
                raise SystemExit(f"FAIL count_ge_level on its special lanes, "
                                 f"B={n} {dt}: kernel differs from its plain "
                                 f"version (max |diff| "
                                 f"{max_abs_diff(want, got)})")
            r["checked"] += 1
    try:
        count_ge_level(x.to(dev), torch.ones((w, EDGE_TAUS[-1] + 1),
                                             device=dev))
    except ValueError:
        pass
    else:
        raise SystemExit(f"FAIL count_ge_level took {EDGE_TAUS[-1] + 1} "
                         f"taus")
    log(f"[kernels] count_ge_level on five special lanes at d={LANES_D}, "
        f"B in {EDGE_TAUS}, float32 and bfloat16: equal to the plain "
        f"version bit for bit; {EDGE_TAUS[-1] + 1} taus refused "
        f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def paper_data():
    """The paper's configuration and synthetic MNIST on the card."""
    from repro_torch.configs import PAPER
    from repro_torch.data import make_synthetic_mnist, partition_iid

    pc = PAPER
    k = pc.num_clients
    train = make_synthetic_mnist(SEED, k * 500, device="cuda")
    test = make_synthetic_mnist(SEED + 1, 2000, device="cuda")
    fed = partition_iid(train, k, torch.Generator().manual_seed(SEED + 2))
    return pc, fed, test


def main_path(level, data) -> dict:
    from repro_torch.core import comm_cost as cc
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.fed import Simulator
    from repro_torch.topo import star_tree

    pc, fed, test = data
    k = pc.num_clients
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
                for fn in level.KERNELS[:3]}
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


# ---------------------------------------------------------------------------
# phase 4: the main path under threshold Top-Q
# ---------------------------------------------------------------------------

class TauRecorder:
    """Records (τ, per-round counts) of every fused-operand τ search while
    active, by asking the search for its counts too (τ is unchanged)."""

    def __init__(self, sp):
        self.sp, self.orig, self.log = sp, sp.threshold_for_topq, []

    def __enter__(self):
        self.log = []

        def search(x, q, **kw):
            if kw.get("operand_fn") is None or kw.get("with_counts"):
                return self.orig(x, q, **kw)
            tau, counts = self.orig(x, q, with_counts=True, **kw)
            self.log.append((tau.cpu(), counts.cpu()))
            return tau

        self.sp.threshold_for_topq = search
        return self.log

    def __exit__(self, *exc):
        self.sp.threshold_for_topq = self.orig


def card_matches_cpu(sim_card, sim_cpu, label: str, rounds: int = 3):
    """``rounds`` rounds on the chain, both simulators fed the gradients
    of the CPU run: τ, counts, model, EF rows and bits bit for bit; the
    loss (a reduction on each device) to rtol 1e-4."""
    from repro_torch.agg import compile_plan
    from repro_torch.core import sparsify as sp
    from repro_torch.data.federated import client_minibatch

    plan = compile_plan(sim_cpu.k, num_clients=sim_cpu.k)
    gen = torch.Generator().manual_seed(SEED)
    s_cpu, s_card = sim_cpu.init(), sim_card.init()
    worst = 0.0
    for r in range(rounds):
        bx, by = client_minibatch(sim_cpu.fed, sim_cpu.pc.batch_size, gen)
        grads = sim_cpu.client_grads(s_cpu.flat_w, bx, by)
        with TauRecorder(sp) as taus_cpu:
            s_cpu, l_cpu = sim_cpu.aggregate_step(s_cpu, plan, grads)
        with TauRecorder(sp) as taus_card:
            s_card, l_card = sim_card.aggregate_step(s_card, plan,
                                                     grads.cuda())
        same = (len(taus_cpu) == len(taus_card) > 0 and all(
            bitwise_equal(a, b) and bitwise_equal(c, e)
            for (a, c), (b, e) in zip(taus_cpu, taus_card)))
        same = same and all(bitwise_equal(u, v) for u, v in (
            (s_cpu.flat_w, s_card.flat_w), (s_cpu.ef, s_card.ef),
            (l_cpu.stats.bits, l_card.stats.bits),
            (l_cpu.stats.nnz_out, l_card.stats.nnz_out)))
        rel = abs(float(l_card.loss) - float(l_cpu.loss)) / abs(
            float(l_cpu.loss))
        worst = max(worst, rel)
        if not same or rel > 1e-4:
            raise SystemExit(f"FAIL {label} round {r}: card and CPU differ "
                             f"(τ/counts/state/bits equal: {same}, loss rel "
                             f"{rel:.2e})")
    log(f"[threshold] {label}: {rounds} rounds on the card vs the CPU with "
        f"the same gradients: τ ({len(taus_card)} searches per round), "
        f"counts, model and bits equal bit for bit; loss max rel diff "
        f"{worst:.2e}")


def threshold_path(level, data) -> dict:
    from repro_torch.core import sparsify as sp
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.fed import Simulator
    from repro_torch.kernels import ops
    from repro_torch.topo import star_tree

    pc, fed, test = data
    k = pc.num_clients
    kw = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local,
              topq_impl="threshold", hist_branch=BRANCH)
    kinds = [AggKind.SIA, AggKind.RE_SIA, AggKind.CL_SIA, AggKind.TC_SIA,
             AggKind.CL_TC_SIA]
    topos = [("chain", None, k), ("star", star_tree(k), 1)]
    cfg = lambda kind, impl, **o: AggConfig(kind=kind, **kw,  # noqa: E731
                                            **{**THRESHOLD[impl], **o})
    sims = {(kind, impl): Simulator(pc, cfg(kind, impl), fed, device="cuda")
            for kind in kinds for impl in THRESHOLD}
    t0 = time.perf_counter()
    for sim in sims.values():
        sim.run(1, seed=SEED)
    torch.cuda.synchronize()
    log(f"[threshold] warm-up, one round of each: "
        f"{time.perf_counter() - t0:.1f} s")

    names = {"scan": "count_ge_fused_level", "hist": "hist_topq_level"}
    level.reset_launch_counts()
    torch.cuda.synchronize()
    results = {}
    for impl in THRESHOLD:
        for kind in kinds:
            for topo_name, topo, levels in topos:
                before = {f.__name__: f.launches for f in level.KERNELS}
                t0 = time.perf_counter()
                out = sims[(kind, impl)].run(ROUNDS, seed=SEED,
                                             topology=topo, test_x=test.x,
                                             test_y=test.y,
                                             eval_every=ROUNDS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                results[(kind, impl, topo_name)] = out
                grown = {n.replace("_cuda", ""): f.launches - before[n]
                         for n, f in ((f.__name__, f) for f in level.KERNELS)}
                per_round = THRESHOLD[impl]["hist_rounds"] if impl == "scan" \
                    else 1
                want = ROUNDS * per_round * levels
                other = names["hist" if impl == "scan" else "scan"]
                if grown[names[impl]] != want or grown[other] != 0:
                    raise SystemExit(
                        f"FAIL {kind.value} {impl} {topo_name}: launches "
                        f"{grown}, predicted {names[impl]} = {want}")
                log(f"[threshold] {kind.value:9s} {impl} {topo_name:5s}: "
                    f"loss {out['loss'][0]:.4f} -> {out['loss'][-1]:.4f}, "
                    f"acc {out['accuracy'][-1][1]:.3f}, bits/round "
                    f"{np.mean(out['bits']):.0f}, "
                    f"{1e3 * wall / ROUNDS:.2f} ms/round; "
                    f"{names[impl]} launches {grown[names[impl]]} "
                    f"(predicted {want})")
    launches = {name: getattr(level, name + "_cuda").launches
                for name in names.values()}
    log(f"[threshold] τ-search launches over the threshold runs: "
        f"{launches}; level kernels: "
        + str({f.__name__.replace("_cuda", ""): f.launches
               for f in level.KERNELS[:3]}))
    for name in names.values():
        if launches[name] <= 0:
            raise SystemExit(f"FAIL {name} was never launched on the "
                             f"threshold path")
    for key, out in results.items():
        if not all(math.isfinite(v) for v in out["loss"]):
            raise SystemExit(f"FAIL {key}: loss not finite")
        if not out["loss"][-1] < out["loss"][0]:
            raise SystemExit(f"FAIL {key}: loss did not fall "
                             f"({out['loss'][0]} -> {out['loss'][-1]})")
        if not all(b >= 0 for b in out["bits"]):
            raise SystemExit(f"FAIL {key}: bad bits")

    # hist ≡ scan at the same two rounds, round by round
    n_cmp = 5
    for kind in kinds:
        scan2 = Simulator(pc, cfg(kind, "scan", hist_rounds=2), fed,
                          device="cuda")
        for topo_name, topo, _ in topos:
            a = scan2.run(n_cmp, seed=SEED, topology=topo)
            b = sims[(kind, "hist")].run(n_cmp, seed=SEED, topology=topo)
            if a["bits"] != b["bits"] or a["loss"] != b["loss"]:
                raise SystemExit(
                    f"FAIL {kind.value} {topo_name}: hist differs from the "
                    f"scan at 2 rounds (bits {a['bits']} vs {b['bits']}, "
                    f"loss {a['loss']} vs {b['loss']})")
    log(f"[threshold] hist = scan at hist_rounds=2, bits and loss bit for "
        f"bit over {n_cmp} rounds, every kind on chain and star")

    for kind in kinds:
        for impl in THRESHOLD:
            card_matches_cpu(sims[(kind, impl)],
                             Simulator(pc, cfg(kind, impl), fed,
                                       device="cpu"),
                             f"{kind.value} {impl}")

    # the count_fn path: counts over a materialized [28, 7850] operand
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (k, pc.d)).astype(np.float32))
    want = sp.threshold_for_topq(x, pc.q)
    level.reset_launch_counts()
    torch.cuda.synchronize()
    got = sp.threshold_for_topq(x.cuda(), pc.q, count_fn=ops.count_ge_level)
    torch.cuda.synchronize()
    launches["count_ge_level"] = level.count_ge_level_cuda.launches
    default = sp.threshold_for_topq(x.cuda(), pc.q)
    if not (bitwise_equal(want, got) and bitwise_equal(want, default)):
        raise SystemExit("FAIL threshold_for_topq(count_fn=count_ge_level) "
                         "on the card differs from the default search")
    if launches["count_ge_level"] != 3:
        raise SystemExit(f"FAIL count_ge_level launched "
                         f"{launches['count_ge_level']} times, predicted 3")
    log(f"[threshold] count_fn=count_ge_level on the card: τ equal to the "
        f"default search on the card and the CPU; "
        f"{launches['count_ge_level']} launches (one per round)")

    for impl in THRESHOLD:
        for topo_name, topo, _ in topos:
            profile_rounds(sims[(AggKind.CL_SIA, impl)],
                           f"cl_sia threshold {impl} {topo_name}", topo)
    return launches


# ---------------------------------------------------------------------------
# phase 2 (continued): the scalar [d] kernels
# ---------------------------------------------------------------------------

def scalar_variants():
    """(kernel, options) for every variant: both dtypes, mask_in on/off,
    include_gamma on/off, the scalars as numbers and as tensors on the card
    (a CPU-side plain result serves both scalar forms)."""
    for dt in SCALAR_DTYPES:
        yield "count_ge", dict(dtype=dt)
        for gamma in (False, True):
            yield "count_ge_fused", dict(dtype=dt, gamma=gamma)
        for mask in (False, True):
            yield "sparsify_ef", dict(dtype=dt, mask=mask)
        yield "cl_fuse", dict(dtype=dt)
        yield "chain_accum", dict(dtype=dt)


SCALAR_TIMED = {"count_ge": dict(gamma=False, mask=False),
                "count_ge_fused": dict(gamma=True, mask=False),
                "sparsify_ef": dict(gamma=False, mask=True),
                "cl_fuse": dict(gamma=False, mask=False),
                "chain_accum": dict(gamma=False, mask=False)}


def scalar_inputs(d: int, seed: int) -> dict:
    """float32 numpy rows and 64 shuffled taus with τ = −1, 0, +inf and a
    tie; the scalars w = 1.3, τ = 1.1, p = 0.6."""
    rng = np.random.default_rng(seed)
    f = lambda s: (rng.standard_normal(d, dtype=np.float32)  # noqa: E731
                   * np.float32(s))
    x = dict(g=f(1.0), e=f(0.3), gin=f(1.0),
             mask=(rng.random(d, dtype=np.float32) < 0.01).astype(
                 np.float32))
    x["gin"] *= rng.random(d, dtype=np.float32) < 0.3
    taus = np.abs(rng.standard_normal(BRANCH)).astype(np.float32) * 1.5
    taus[:4] = [-1.0, 0.0, np.inf, taus[9]]
    x["taus"] = rng.permutation(taus)
    return x


def call_scalar(fns, name: str, t: dict, opt: dict, sc: dict):
    """Call scalar kernel ``name`` (from ``fns``: the CUDA wrappers or the
    plain versions) on rows ``t`` with scalars ``sc`` (w, tau, p)."""
    if name == "count_ge":
        return (fns[name](t["g"], t["taus"]),)
    if name == "count_ge_fused":
        return (fns[name](t["g"], t["e"], t["gin"], sc["w"], sc["p"],
                          t["taus"], include_gamma=opt["gamma"]),)
    if name == "sparsify_ef":
        return fns[name](t["g"], t["e"], t["mask"] if opt["mask"] else None,
                         sc["w"], sc["tau"])
    if name == "cl_fuse":
        return fns[name](t["g"], t["e"], t["gin"], sc["w"], sc["tau"])
    return fns[name](t["gin"], t["g"])


def scalar_cost(name: str, d: int, es: int, opt: dict) -> tuple:
    """(bytes, f32 operations) a call must spend: each input read once and
    each output written once (es bytes per row element, the float32 mask,
    taus, counts and scalars included); per element the operand's flops and
    the rank search's compares."""
    search = math.ceil(math.log2(BRANCH + 1))
    taus = 2 * BRANCH * 4                          # taus in, counts out
    if name == "count_ge":
        return d * es + taus, d * (1 + search)
    if name == "count_ge_fused":
        rows = 3 if opt["gamma"] else 2
        return rows * d * es + 8 + taus, d * (2 * (rows - 1) + 1 + search)
    if name == "sparsify_ef":                      # g, e (mask) → ḡ, e′
        return 4 * d * es + opt["mask"] * d * 4 + 12, d * 5
    if name == "cl_fuse":                          # g, e, γ_in → γ, e′
        return 5 * d * es + 12, d * 6
    return 3 * d * es + 4, d * 2                   # γ_in, ḡ → γ


def check_scalar_kernels(scalar, ref) -> dict:
    """Every scalar kernel over its variants at SCALAR_SHAPES, bit for bit
    against its plain version on the CPU and on the card; then timed."""
    cuda_fns, plain_fns = scalar, {n: getattr(ref, "ref_" + n)
                                   for n in scalar}
    report = {n: dict(max_abs_err=0.0, max_abs_err_plain_on_card=0.0,
                      checked=0, shapes=[]) for n in cuda_fns}
    dev = torch.device("cuda")
    sc_cpu = dict(w=1.3, tau=1.1, p=0.6)
    sc_card = {k: torch.tensor([v], dtype=torch.float32, device=dev)
               for k, v in sc_cpu.items()}
    for si, d in enumerate(SCALAR_SHAPES):
        t0 = time.perf_counter()
        x = scalar_inputs(d, SEED + 20 + si)
        for dt in SCALAR_DTYPES:
            cpu = {k: torch.from_numpy(v).to(dt if k in ("g", "e", "gin")
                                             else torch.float32)
                   for k, v in x.items()}
            gpu = {k: v.to(dev) for k, v in cpu.items()}
            for name, opt in scalar_variants():
                if opt["dtype"] != dt:
                    continue
                want = call_scalar(plain_fns, name, cpu, opt, sc_cpu)
                on_card = call_scalar(plain_fns, name, gpu, opt, sc_card)
                r = report[name]
                takes_scalars = name not in ("count_ge", "chain_accum")
                for sc in (sc_cpu, sc_card)[:1 + takes_scalars]:
                    got = call_scalar(cuda_fns, name, gpu, opt, sc)
                    torch.cuda.synchronize()
                    for a, b, c in zip(want, got, on_card):
                        r["max_abs_err"] = max(r["max_abs_err"],
                                               max_abs_diff(a, b))
                        r["max_abs_err_plain_on_card"] = max(
                            r["max_abs_err_plain_on_card"],
                            max_abs_diff(c, b))
                        if not (bitwise_equal(a, b) and bitwise_equal(c, b)):
                            raise SystemExit(
                                f"FAIL {name} {opt} scalars "
                                f"{'on the card' if sc is sc_card else 'as numbers'}"
                                f" at d={d}: kernel differs from its plain "
                                f"version (CPU max |diff| "
                                f"{max_abs_diff(a, b)}, card "
                                f"{max_abs_diff(c, b)})")
                    r["checked"] += 1
                del want, on_card
            big = d > 10 ** 7
            for name, opt in SCALAR_TIMED.items():
                opt = dict(opt, dtype=dt)
                ms = cuda_time_ms(lambda: call_scalar(
                    cuda_fns, name, gpu, opt, sc_card), 20 if big else 200)
                plain_ms = cuda_time_ms(lambda: call_scalar(
                    plain_fns, name, gpu, opt, sc_card), 5 if big else 50)
                nbytes, ops_n = scalar_cost(name, d, dt.itemsize, opt)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = ops_n / F32_OPS_PER_S * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                report[name]["shapes"].append(dict(
                    d=d, dtype=str(dt).replace("torch.", ""), ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    bound_share=bound_ms / ms))
                log(f"[time] {name} d={d} {dt}: kernel {ms:.4f} ms, plain "
                    f"on card {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({100 * bound_ms / ms:.1f}% of bound)")
            del cpu, gpu
            torch.cuda.empty_cache()
        log(f"[kernels] d={d}: every scalar kernel variant bitwise equal to "
            f"its plain version on the CPU and on the card "
            f"({time.perf_counter() - t0:.1f} s)")
    check_count_ge_edges(cuda_fns["count_ge"], ref, report["count_ge"])
    return report


def check_count_ge_edges(count_ge, ref, r: dict):
    """count_ge at d = SEARCH_D on the bucket edges of its rank table and
    on the taus (one ulp either side), with NaN, ±inf, ±0 and subnormal
    elements; taus in any order with −1, 0, +inf, NaN, ties and taus on
    bucket boundaries, B = 1, 64 and 4095 (MAX_TAUS); float32 and
    bfloat16; bit for bit against the plain version on the CPU. 4096 taus
    must be refused."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for n in EDGE_TAUS:
        taus = ref.count_edge_taus(n, seed=SEED + n)
        x = ref.count_edge_magnitudes(taus, SEARCH_D, seed=SEED + n)
        x[:1000] = ref.special_magnitudes(1000, seed=SEED + n)
        for dt in SCALAR_DTYPES:
            row = x.to(dt)
            want = ref.ref_count_ge(row, taus)
            got = count_ge(row.to(dev), taus.to(dev))
            torch.cuda.synchronize()
            r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(want, got))
            if not bitwise_equal(want, got):
                raise SystemExit(f"FAIL count_ge on its rank table's edges, "
                                 f"B={n} {dt}: kernel differs from its plain "
                                 f"version (max |diff| "
                                 f"{max_abs_diff(want, got)})")
            r["checked"] += 1
    try:
        count_ge(x.to(dev), torch.ones(EDGE_TAUS[-1] + 1, device=dev))
    except ValueError:
        pass
    else:
        raise SystemExit(f"FAIL count_ge took {EDGE_TAUS[-1] + 1} taus")
    log(f"[kernels] count_ge on its rank table's edges at d={SEARCH_D}, "
        f"B in {EDGE_TAUS}, float32 and bfloat16: equal to the plain version "
        f"bit for bit; {EDGE_TAUS[-1] + 1} taus refused "
        f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 5: the scalar kernel API and the 1-D τ search
# ---------------------------------------------------------------------------

def scalar_chain(sp, ops, ref, grads, ef, weights, q: int, kind: str):
    """One chain pass of K scalar node steps through the ``ops`` entries:
    each node's τ from ``threshold_for_topq`` over the fused operand counted
    by ``count_ge_fused``, then ``sparsify_ef`` + ``chain_accum`` (SIA) or
    ``cl_fuse`` (CL-SIA). τ and the weights stay on the rows' device.
    → (γ at the PS, new EF rows, [τ], [nnz])."""
    gamma_in = torch.zeros_like(grads[0])
    one = torch.ones((1,), dtype=torch.float32, device=grads.device)
    gamma_on = kind == "cl_sia"
    e_new, taus, nnzs = [], [], []
    for k in range(grads.shape[0]):
        g, e, w = grads[k], ef[k], weights[k:k + 1]
        gin = gamma_in

        def count(t, g=g, e=e, w=w, gin=gin):
            return ops.count_ge_fused(g, e, gin, w, one, t,
                                      include_gamma=gamma_on)

        def max_abs(g=g, e=e, w=w, gin=gin):
            return ref.fused_operand(g[None], e[None], gin[None], w, one,
                                     include_gamma=gamma_on).abs().amax()

        tau = sp.threshold_for_topq(None, q, operand_fn=sp.TauOperand(
            count=count, max_abs=max_abs, batched=False), branch=BRANCH)
        if gamma_on:
            gamma_in, e_k, nnz = ops.cl_fuse(g, e, gin, w, tau)
        else:
            gbar, e_k, _ = ops.sparsify_ef(g, e, None, w, tau)
            gamma_in, nnz = ops.chain_accum(gin, gbar)
        e_new.append(e_k)
        taus.append(tau)
        nnzs.append(nnz)
    return gamma_in, torch.stack(e_new), torch.stack(taus), torch.stack(nnzs)


def scalar_path(level, scalar) -> dict:
    from repro_torch.configs import PAPER
    from repro_torch.core import sparsify as sp
    from repro_torch.kernels import ops, ref

    k, d, q = PAPER.num_clients, PAPER.d, PAPER.q
    rng = np.random.default_rng(SEED + 30)
    grads = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32))
    ef = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32)
                          * np.float32(0.1))
    weights = torch.from_numpy(rng.uniform(0.5, 1.5, k).astype(
        np.float32) / np.float32(k))
    xs = torch.from_numpy(rng.standard_normal(SEARCH_D, dtype=np.float32))
    card = [t.cuda() for t in (grads, ef, weights, xs)]
    kinds = ("sia", "cl_sia")
    for kind in kinds:                     # warm-up: first use of each op
        scalar_chain(sp, ops, ref, *card[:3], q, kind)
    sp.threshold_for_topq(card[3], q, count_fn=ops.count_ge)
    torch.cuda.synchronize()

    level.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    taus_card = [sp.threshold_for_topq(card[3], qq, count_fn=ops.count_ge)
                 for qq in SEARCH_QS]
    torch.cuda.synchronize()
    search_ms = (time.perf_counter() - t0) * 1e3 / len(SEARCH_QS)
    chains, chain_ms = {}, {}
    for kind in kinds:
        t0 = time.perf_counter()
        chains[kind] = scalar_chain(sp, ops, ref, *card[:3], q, kind)
        torch.cuda.synchronize()
        chain_ms[kind] = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__.replace("_cuda", ""): fn.launches
                for fn in scalar.values()}
    rounds = 3                                     # scan rounds per search
    want = dict(count_ge=rounds * len(SEARCH_QS),
                count_ge_fused=rounds * k * len(kinds), sparsify_ef=k,
                chain_accum=k, cl_fuse=k)
    log(f"[scalar] launches over the scalar path: {launches} (predicted "
        f"{want}); 1-D search at d={SEARCH_D}: {search_ms:.2f} ms per "
        f"search; chain of {k} scalar node steps at d={d}: "
        + ", ".join(f"{kk} {v:.2f} ms" for kk, v in chain_ms.items())
        + " (host clock, synchronized)")
    if launches != want:
        raise SystemExit(f"FAIL scalar path launches {launches}, predicted "
                         f"{want}")

    for qq, got in zip(SEARCH_QS, taus_card):
        cpu = sp.threshold_for_topq(xs, qq, count_fn=ops.count_ge)
        default = sp.threshold_for_topq(xs, qq)
        kept = int((card[3].abs() >= got).sum())
        if not (bitwise_equal(cpu, got) and bitwise_equal(default, got)
                and qq <= kept):
            raise SystemExit(f"FAIL 1-D search q={qq}: card τ {float(got)!r}"
                             f", CPU {float(cpu)!r}, default "
                             f"{float(default)!r}, {kept} kept")
    log(f"[scalar] 1-D search, count_fn=ops.count_ge on the card: τ equal "
        f"to the CPU's bit for bit for q in {SEARCH_QS}")
    for kind in kinds:
        cpu = scalar_chain(sp, ops, ref, grads, ef, weights, q, kind)
        got = chains[kind]
        if not all(bitwise_equal(a, b) for a, b in zip(cpu, got)):
            raise SystemExit(f"FAIL scalar {kind} chain: card and CPU differ "
                             f"(γ, EF, τ, nnz equal: "
                             f"{[bitwise_equal(a, b) for a, b in zip(cpu, got)]})")
        gamma, _, _, nnz = got
        if not (bool(torch.isfinite(gamma).all()) and int(nnz[-1]) >= q):
            raise SystemExit(f"FAIL scalar {kind} chain: bad result")
        log(f"[scalar] {kind} chain: γ, EF rows, τ and nnz on the card equal "
            f"the CPU's bit for bit; nnz at the PS {int(nnz[-1])}")
    for kind in kinds:
        profile_calls(f"scalar {kind} chain", lambda: scalar_chain(
            sp, ops, ref, *card[:3], q, kind), 1)
    profile_calls("1-D search", lambda: sp.threshold_for_topq(
        card[3], SEARCH_QS[0], count_fn=ops.count_ge), 1)
    return launches


def profile_rounds(sim, label: str, topology, rounds: int = 3):
    """Device busy time and device-op count over a few rounds."""
    sim.run(1, topology=topology)
    profile_calls(label, lambda: sim.run(rounds, seed=SEED,
                                         topology=topology), rounds)


def profile_calls(label: str, fn, rounds: int):
    """Device busy time and device-op count per round of ``fn`` (which
    runs ``rounds`` rounds), from torch.profiler (its own overhead inflates
    the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
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
    from repro_torch.core import sparsify as sp
    from repro_torch.kernels import (chain_accum, level, ref, sparsify_ef,
                                     topq_threshold)

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

    scalar = {fn.__name__.replace("_cuda", ""): fn
              for fn in (chain_accum.chain_accum_cuda,
                         chain_accum.cl_fuse_cuda,
                         sparsify_ef.sparsify_ef_cuda,
                         topq_threshold.count_ge_cuda,
                         topq_threshold.count_ge_fused_cuda)}
    report = check_kernels(level, ref)
    report.update(check_tau_kernels(level, ref, sp))
    report.update(check_scalar_kernels(scalar, ref))
    data = paper_data()
    launches = main_path(level, data)
    launches.update(threshold_path(level, data))
    launches.update(scalar_path(level, scalar))

    csrc = "src/repro_torch/kernels/csrc/"
    source = {"cl_fuse_level": "level.cu", "sparsify_ef_level": "level.cu",
              "chain_accum_level": "level.cu",
              "count_ge_fused_level": "tau_search.cu",
              "hist_topq_level": "tau_search.cu",
              "count_ge_level": "tau_search.cu",
              "chain_accum": "chain_accum.cu", "cl_fuse": "chain_accum.cu",
              "sparsify_ef": "sparsify_ef.cu",
              "count_ge": "topq_threshold.cu",
              "count_ge_fused": "topq_threshold.cu"}
    replaces = {"cl_fuse_level": "src/repro/kernels/level.py:395",
                "sparsify_ef_level": "src/repro/kernels/level.py:197",
                "chain_accum_level": "src/repro/kernels/level.py:282",
                "count_ge_fused_level": "src/repro/kernels/level.py:561",
                "hist_topq_level": "src/repro/kernels/level.py:684",
                "count_ge_level": "src/repro/kernels/level.py:481",
                "chain_accum": "src/repro/kernels/chain_accum.py:74",
                "cl_fuse": "src/repro/kernels/chain_accum.py:102",
                "sparsify_ef": "src/repro/kernels/sparsify_ef.py:70",
                "count_ge": "src/repro/kernels/topq_threshold.py:79",
                "count_ge_fused": "src/repro/kernels/topq_threshold.py:157"}
    kernels = []
    for name, r in report.items():
        # the large float32 shape (a scalar kernel's last shape is bf16)
        large = [x for x in r["shapes"] if x.get("dtype") != "bfloat16"][-1]
        kernels.append(dict(
            name=name, route="cuda", source=csrc + source[name],
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=large["ms"],
            plain_ms=large["plain_ms"], bound_ms=large["bound_ms"],
            bound_by=large.get("bound_by", "bytes"), library_ms=None,
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
