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
   and its bound; the four kernels that take a global mask also in its
   cohort-shared [B, d] form (``gmask_cohorts=B``) at the large shape with
   B = 2 and 8 and at the paper's batched round (8 cohorts × 28 lanes,
   d = 7850), held and timed the same way (the bound counts B·d mask
   bytes);
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
   the same run on the CPU bit for bit;
6. routed constellation trees — the paper simulator (K = 28, d = 7850,
   exact Top-Q) on ``walker_delta(4, 7, gateways=(1, 15))`` routed by
   widest path, 20 rounds each after a warm-up: CL-SIA and SIA with
   ``tree_topology`` and a ``FailureSchedule`` that kills client 0 in
   rounds 2-7 (the tree re-routes from (L, W) = (8, 5) to (10, 4)), CL-SIA
   on a ``TopologySchedule.from_link_events`` schedule (two trees padded to
   one shape, so ``valid == 0`` lanes reach the kernels), and SIA on the
   bandwidth-aware plan (per-client ``q_budget``); level-kernel launches
   held to one per level of each round's plan, the loss must fall, CL-SIA's
   bits must equal the §V closed form over the live uplinks every round,
   three rounds across a re-route on the card fed the CPU run's gradients
   must give the CPU's model, EF rows, bits and nnz bit for bit (loss to
   rtol 1e-4), and a padded plan must give the same round as the same plan
   unpadded; ms per round beside the chain round of the same run, and
   torch.profiler's device-busy share of a tree round;
7. multi-tenant cohort rounds — ``Simulator.run_batched`` (K = 28,
   d = 7850, B = 8 seeds, 10 rounds after a warm-up): TC-SIA and CL-TC-SIA
   on the chain and the star, CL-TC-SIA on phase 6's Walker tree through
   its relay failure, and TC-SIA under threshold Top-Q (scan and hist) on
   the chain; level-kernel launches held to one per level of each round's
   plan for all cohorts together (not B per level), every cohort equal to
   the sequential ``run(seed)`` on the card bit for bit (model, EF rows,
   bits, nnz), the loss falling in every cohort, three batched rounds on
   the card fed the CPU's gradients equal to the CPU's bit for bit (four
   of the runs), and a ``RoundScheduler`` fed a chain, a star, a Walker
   tree and a K = 4 chain meeting no more input signatures than buckets;
   then one batched round against B sequential rounds at B = 1, 2, 4, 8
   (host clock), and torch.profiler's device ops and busy time of a
   batched round;
8. nested plans, the trace collector and scenarios — the level kernels
   (table rows 1-5) at an upper stage's shapes (W = 1, 2, 4 lanes at
   d = 7850, ``g`` a view of sink rows inside the inbox) bit for bit
   against their plain versions; then the paper simulator (K = 28,
   d = 7850) with ``nested_topology``: CL-SIA on ``pod_ring_nested(4, 7)``
   and CL-TC-SIA and SIA on ``cluster_routed(walker_delta(4, 7,
   gateways=(1, 15)), 4)`` for 20 rounds, TC-SIA under threshold scan and
   hist for 3, each under a ``TraceCollector``: level-kernel launches held
   to Σ over rounds of Σ_s L_s, each stage's bits equal to its staged
   closed form (CL) or under its staged bound (SIA, TC-SIA) every round,
   the loss falling; a clustered Walker scenario (a relay crash and a
   ground-link flap, 20 rounds) recorded under a collector, its trace
   valid and exact against the report's closed-form check, one input
   signature, and a replay from the trace giving the same round records;
   three nested rounds on the card fed the CPU's gradients equal to the
   CPU's bit for bit, stage EF tiers included; ms per round with the
   collector off, flushing every round and every 32 rounds, and of the
   flat Walker tree round, timed in five turns (medians); torch.profiler's
   device ops and busy time of a nested round.

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


def kernel_bytes(name: str, w: int, d: int, mask_rows: int = 1) -> int:
    """Bytes the timed variant must move: each input read once, each
    output written once (per-lane scalars and counts included); the global
    mask is ``mask_rows`` rows of d (1: lane-shared, B: cohort-shared)."""
    m = mask_rows * d
    if name == "cl_fuse_level":        # g,e,γ_in,mask_in,gm → γ,e′
        return (6 * w * d + m) * 4 + 4 * w * 4 + 2 * w * 4
    if name == "sparsify_ef_level":    # g,e,mask_in → ḡ,e′
        return 5 * w * d * 4 + 3 * w * 4 + w * 4
    return (3 * w * d + m) * 4 + w * 4 + 2 * w * 4   # γ_in,ḡ,gm → γ


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


def tau_cost(name: str, w: int, d: int, n: int,
             mask_rows: int = 1) -> tuple:
    """(bytes, f32 operations) the timed variant must spend: each input
    read once, each output written once; per element the operand's flops
    and the binary searches' compares (and candidate fmas), or for
    ``count_ge_level`` the table lookup (|x|, its bucket, one compare).
    The global mask is ``mask_rows`` rows of d."""
    search = math.ceil(math.log2(n + 1))
    if name == "count_ge_level":
        return (w * d + 2 * w * n) * 4, w * d * 3
    operand = (3 * w * d + mask_rows * d + 2 * w) * 4   # g, e, γ_in, gm, w, p
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
            (l_cpu.stats[0].bits, l_card.stats[0].bits),
            (l_cpu.stats[0].nnz_out, l_card.stats[0].nnz_out)))
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
# phase 2 (continued): the cohort-shared [B, d] global mask
# ---------------------------------------------------------------------------

# (W lanes, d, B cohorts): the large shape with 2 and 8 cohorts (B·d % 4 ≠
# 0 for every cohort row b > 0), and the paper's batched round, 8 cohorts
# of 28 lanes
COHORT_SHAPES = [(LARGE[0], LARGE[1], 2), (LARGE[0], LARGE[1], 8),
                 (8 * 28, 7850, 8)]
COHORT_KERNELS = ("cl_fuse_level", "chain_accum_level",
                  "count_ge_fused_level", "hist_topq_level")


def call_cohort(fns, name: str, t: dict, b: int, tables):
    """Kernel ``name`` (CUDA wrapper or plain version) with the cohort
    mask ``t["gmc"]`` of ``b`` cohorts: CL with mask_in, the τ search with
    γ_in (the CL-TC-SIA operand)."""
    if name == "cl_fuse_level":
        return fns[name](t["g"], t["e"], t["gin"], t["weight"], t["tau"],
                         t["part"], t["valid"], t["gmc"], t["mask"],
                         gmask_cohorts=b)
    if name == "chain_accum_level":
        return fns[name](t["gin"], t["g"], t["valid"], t["gmc"],
                         gmask_cohorts=b)
    operand = (t["g"], t["e"], t["gin"], t["weight"], t["part"])
    if name == "count_ge_fused_level":
        return (fns[name](*operand, tables[0], t["gmc"], include_gamma=True,
                          gmask_cohorts=b),)
    return fns[name](*operand, tables, t["gmc"], include_gamma=True,
                     gmask_cohorts=b)


def check_cohort_kernels(level, ref, sp, report: dict):
    """The four kernels that take a global mask, in its cohort-shared
    [B, d] form, at COHORT_SHAPES: bit for bit against their plain
    versions on the CPU (a straggler, a ``valid == 0`` and a τ = +inf lane
    among them), then timed beside their plain versions on the card; the
    bound counts B·d mask bytes."""
    cuda_fns = {n: getattr(level, n + "_cuda") for n in COHORT_KERNELS}
    plain_fns = {n: getattr(ref, "ref_" + n) for n in COHORT_KERNELS}
    dev = torch.device("cuda")
    inputs = {}
    for w, d, b in COHORT_SHAPES:
        t0 = time.perf_counter()
        if (w, d) not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            inputs[(w, d)] = {k: torch.from_numpy(v) for k, v in
                              make_inputs(w, d, SEED + 40 + w).items()
                              if k not in ("gm", "gmw")}
        cpu = dict(inputs[(w, d)])
        rng = np.random.default_rng(SEED + 50 + b)
        cpu["gmc"] = torch.from_numpy(
            (rng.random((b, d), dtype=np.float32) < 0.1).astype(np.float32))
        op = ref.fused_operand(cpu["g"], cpu["e"], cpu["gin"], cpu["weight"],
                               cpu["part"], cpu["gmc"], include_gamma=True,
                               gmask_cohorts=b)
        hi = torch.clamp(op.abs().amax(-1), min=1e-30) * sp._HI_SCALE
        tables = sp._hist_tables(torch.zeros_like(hi), hi, BRANCH)
        del op
        gpu = {k: v.to(dev) for k, v in cpu.items()}
        tables_gpu = tuple(u.to(dev) for u in tables)
        for name in COHORT_KERNELS:
            got = call_cohort(cuda_fns, name, gpu, b, tables_gpu)
            torch.cuda.synchronize()
            want = call_cohort(plain_fns, name, cpu, b, tables)
            on_card = call_cohort(plain_fns, name, gpu, b, tables_gpu)
            r = report[name]
            for u, v, c in zip(want, got, on_card):
                r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(u, v))
                r["max_abs_err_plain_on_card"] = max(
                    r["max_abs_err_plain_on_card"], max_abs_diff(c, v))
                if not bitwise_equal(u, v):
                    raise SystemExit(
                        f"FAIL {name} cohort mask B={b} at W={w} d={d}: "
                        f"kernel differs from its plain version on the CPU "
                        f"(max |diff| {max_abs_diff(u, v)})")
            r["checked"] += 1
            r.setdefault("cohort_variants", []).append(
                f"W={w} d={d} B={b}")
            del got, want, on_card
        log(f"[kernels] cohort mask W={w} d={d} B={b}: "
            f"{', '.join(COHORT_KERNELS)} bitwise equal to the plain CPU "
            f"versions ({time.perf_counter() - t0:.1f} s)")
        gpu["valid"].fill_(1.0)
        gpu["part"].fill_(1.0)
        big = w * d > 10 ** 7
        for name in COHORT_KERNELS:
            ms = cuda_time_ms(lambda: call_cohort(cuda_fns, name, gpu, b,
                                                  tables_gpu),
                              20 if big else 200)
            plain_ms = cuda_time_ms(lambda: call_cohort(
                plain_fns, name, gpu, b, tables_gpu), 5 if big else 50)
            if name in ("cl_fuse_level", "chain_accum_level"):
                nbytes, ops_n = kernel_bytes(name, w, d, mask_rows=b), 0
            else:
                nbytes, ops_n = tau_cost(name, w, d, BRANCH, mask_rows=b)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_n / F32_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            report[name]["shapes"].append(dict(
                W=w, d=d, cohorts=b, mask_form="cohort", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_share=bound_ms / ms))
            log(f"[time] {name} cohort mask W={w} d={d} B={b}: kernel "
                f"{ms:.4f} ms, plain on card {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of bound)")
        del cpu, gpu, tables_gpu
        torch.cuda.empty_cache()
    inputs.clear()


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


# ---------------------------------------------------------------------------
# phase 6: routed constellation trees, relay failures, topology schedules
# ---------------------------------------------------------------------------

# walker_delta(4, 7, gateways=(1, 15)): 28 satellites, the paper's K; its
# widest-path tree is (L, W) = (8, 5), (10, 4) with client 0 dead
WALKER = dict(num_planes=4, sats_per_plane=7, gateways=(1, 15))
FAILURES = {2: ([0], []), 8: ([], [0])}          # client 0 dead rounds 2-7
LINK_EVENTS = {3: ([(1, 2), (1, 8)], []), 9: ([], [(1, 2), (1, 8)])}
# the rounds compared card against CPU: each crosses a re-route
TREE_CMP_ROUNDS = {"failure": (1, 2, 3), "links": (2, 3, 4),
                   "budgets": (0, 1, 2)}


def tree_card_matches_cpu(sim_card, sim_cpu, plans, label: str):
    """Rounds over ``plans`` (a re-route among them), both simulators fed
    the CPU run's gradients: model, EF rows, bits and nnz bit for bit,
    the loss to rtol 1e-4."""
    from repro_torch.data.federated import client_minibatch

    gen = torch.Generator().manual_seed(SEED)
    s_cpu, s_card = sim_cpu.init(), sim_card.init()
    worst = 0.0
    for r, plan in enumerate(plans):
        bx, by = client_minibatch(sim_cpu.fed, sim_cpu.pc.batch_size, gen)
        grads = sim_cpu.client_grads(s_cpu.flat_w, bx, by)
        s_cpu, l_cpu = sim_cpu.aggregate_step(s_cpu, plan, grads)
        s_card, l_card = sim_card.aggregate_step(s_card, plan, grads.cuda())
        same = all(bitwise_equal(u, v) for u, v in (
            (s_cpu.flat_w, s_card.flat_w), (s_cpu.ef, s_card.ef),
            (l_cpu.stats[0].bits, l_card.stats[0].bits),
            (l_cpu.stats[0].nnz_out, l_card.stats[0].nnz_out)))
        rel = abs(float(l_card.loss) - float(l_cpu.loss)) / abs(
            float(l_cpu.loss))
        worst = max(worst, rel)
        if not same or rel > 1e-4:
            raise SystemExit(f"FAIL {label} round {r} (plan {plan.shape}): "
                             f"card and CPU differ (state/bits equal: "
                             f"{same}, loss rel {rel:.2e})")
    log(f"[tree] {label}: {len(plans)} rounds over plans "
        f"{[p.shape for p in plans]} on the card vs the CPU with the same "
        f"gradients: model, EF rows, bits and nnz bit for bit; loss max rel "
        f"diff {worst:.2e}")


def padded_equals_unpadded(sim, pairs, label: str):
    """Each (unpadded, padded) plan pair on the card, same state and
    gradients: bits, nnz, EF rows and model bit for bit."""
    rng = np.random.default_rng(SEED + 60)
    k, d = sim.k, sim.d
    grads = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32)
                             * np.float32(0.01)).cuda()
    state = sim.init()._replace(ef=torch.from_numpy(
        rng.standard_normal((k, d), dtype=np.float32)
        * np.float32(1e-3)).cuda())
    for plain, padded in pairs:
        (s1, l1), (s2, l2) = (sim.aggregate_step(state, p, grads)
                              for p in (plain, padded))
        if not all(bitwise_equal(u, v) for u, v in (
                (s1.flat_w, s2.flat_w), (s1.ef, s2.ef),
                (l1.stats[0].bits, l2.stats[0].bits),
                (l1.stats[0].nnz_out, l2.stats[0].nnz_out))):
            raise SystemExit(f"FAIL {label}: plan {plain.shape} and the same "
                             f"plan padded to {padded.shape} differ")
    log(f"[tree] {label}: padded = unpadded on the card, bit for bit, for "
        + ", ".join(f"{a.shape} -> {b.shape}" for a, b in pairs))


def tree_path(level, data) -> dict:
    from repro_torch.agg import TopologySchedule, compile_plan
    from repro_torch.core import comm_cost as cc
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.fed import Simulator
    from repro_torch.fed.topology import FailureSchedule, TreeTopology
    from repro_torch.topo import walker_delta

    pc, fed, test = data
    k = pc.num_clients
    g = walker_delta(**WALKER)
    if g.num_clients != k:
        raise SystemExit(f"FAIL the Walker shell has {g.num_clients} "
                         f"clients, the paper {k}")
    kw = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    topo = TreeTopology(g, "widest")
    fails = FailureSchedule(k, FAILURES)
    sched = TopologySchedule.from_link_events(g, LINK_EVENTS, rounds=ROUNDS,
                                              routing="widest")
    sia = AggConfig(kind=AggKind.SIA, **kw)
    budget_plan = topo.plan(bandwidth_aware=True, cfg=sia)
    budgets = TopologySchedule(plans=(budget_plan,), round_index=(0,))
    # (label, kind, tree_topology, run() keywords, the plan of round r)
    runs = [
        ("cl_sia failure", AggKind.CL_SIA, topo,
         dict(failure_schedule=fails),
         lambda r: topo.plan(dead=tuple(fails.dead_at(r)))),
        ("sia failure", AggKind.SIA, topo, dict(failure_schedule=fails),
         lambda r: topo.plan(dead=tuple(fails.dead_at(r)))),
        ("cl_sia links", AggKind.CL_SIA, None,
         dict(topology_schedule=sched), sched.plan_at),
        ("sia budgets", AggKind.SIA, None, dict(topology_schedule=budgets),
         budgets.plan_at),
    ]
    shapes = {label: sorted({plan_of(r).shape for r in range(ROUNDS)})
              for label, _, _, _, plan_of in runs}
    log(f"[tree] walker_delta(4, 7, gateways=(1, 15)), widest-path: plans "
        f"{shapes}; q_budget {budget_plan.q_budget.tolist()}")
    sims = {label: Simulator(pc, AggConfig(kind=kind, **kw), fed,
                             tree_topology=tt, device="cuda")
            for label, kind, tt, _, _ in runs}
    chain = Simulator(pc, AggConfig(kind=AggKind.CL_SIA, **kw), fed,
                      device="cuda")
    t0 = time.perf_counter()
    for label, _, _, rkw, _ in runs:
        sims[label].run(2, seed=SEED, **rkw)
    chain.run(1, seed=SEED)
    torch.cuda.synchronize()
    log(f"[tree] warm-up: {time.perf_counter() - t0:.1f} s")

    names = [fn.__name__.replace("_cuda", "") for fn in level.KERNELS[:3]]
    level.reset_launch_counts()
    torch.cuda.synchronize()
    results, per_round = {}, {}
    for label, kind, _, rkw, plan_of in runs:
        before = [fn.launches for fn in level.KERNELS[:3]]
        t0 = time.perf_counter()
        out = sims[label].run(ROUNDS, seed=SEED, test_x=test.x,
                              test_y=test.y, eval_every=ROUNDS, **rkw)
        torch.cuda.synchronize()
        per_round[label] = 1e3 * (time.perf_counter() - t0) / ROUNDS
        grown = {n: fn.launches - b for n, fn, b in
                 zip(names, level.KERNELS[:3], before)}
        levels = sum(plan_of(r).shape[0] for r in range(ROUNDS))
        fused = kind == AggKind.CL_SIA
        want = {"cl_fuse_level": levels if fused else 0,
                "sparsify_ef_level": 0 if fused else levels,
                "chain_accum_level": 0 if fused else levels}
        if grown != want:
            raise SystemExit(f"FAIL {label}: level-kernel launches {grown}, "
                             f"predicted {want} (one per level)")
        results[label] = out
        log(f"[tree] {label:15s}: loss {out['loss'][0]:.4f} -> "
            f"{out['loss'][-1]:.4f}, acc {out['accuracy'][-1][1]:.3f}, "
            f"bits/round {np.mean(out['bits']):.0f}, "
            f"{per_round[label]:.2f} ms/round (host clock, synchronized); "
            f"level-kernel launches {grown} = "
            f"{levels / ROUNDS:.1f} per round (predicted)")
    launches = {n: fn.launches for n, fn in zip(names, level.KERNELS[:3])}
    t0 = time.perf_counter()
    chain_out = chain.run(ROUNDS, seed=SEED)
    torch.cuda.synchronize()
    chain_ms = 1e3 * (time.perf_counter() - t0) / ROUNDS
    log(f"[tree] ms per round, same process: chain cl_sia {chain_ms:.2f}; "
        + ", ".join(f"{lb} {ms:.2f}" for lb, ms in per_round.items())
        + f"; launches over the tree runs {launches}")

    for label, out in results.items():
        if not all(math.isfinite(v) for v in out["loss"]):
            raise SystemExit(f"FAIL {label}: loss not finite")
        if not out["loss"][-1] < out["loss"][0]:
            raise SystemExit(f"FAIL {label}: loss did not fall "
                             f"({out['loss'][0]} -> {out['loss'][-1]})")
    expect = cc.cl_sia_bits(k, pc.d, pc.q)
    dead_rounds = [r for r in range(ROUNDS) if fails.dead_at(r)]
    want = [cc.cl_sia_bits_tree(k - len(fails.dead_at(r)), pc.d, pc.q)
            for r in range(ROUNDS)]
    if results["cl_sia failure"]["bits"] != want:
        raise SystemExit(f"FAIL cl_sia failure bits "
                         f"{results['cl_sia failure']['bits']}, closed form "
                         f"over the live uplinks {want}")
    if any(b != expect for b in results["cl_sia links"]["bits"]):
        raise SystemExit(f"FAIL cl_sia links bits differ from the closed "
                         f"form {expect}")
    if chain_out["bits"] != results["cl_sia links"]["bits"]:
        raise SystemExit("FAIL CL-SIA bits differ between chain and tree")
    uniform = results["sia failure"]["bits"]
    log(f"[tree] CL-SIA bits = closed form {expect:.0f} in every round with "
        f"all clients alive (failure run outside rounds {dead_rounds[0]}-"
        f"{dead_rounds[-1]}, every round of the link schedule), and "
        f"{want[dead_rounds[0]]:.0f} (K - 1 uplinks) while client 0 is "
        f"dead; SIA budgets {np.mean(results['sia budgets']['bits']):.0f} "
        f"bits/round vs uniform on the same tree "
        f"{np.mean(uniform[:dead_rounds[0]] + uniform[dead_rounds[-1] + 1:]):.0f}")

    for label, kind, _, _, plan_of in runs:
        tree_card_matches_cpu(
            sims[label], Simulator(pc, AggConfig(kind=kind, **kw), fed,
                                   device="cpu"),
            [plan_of(r) for r in TREE_CMP_ROUNDS[label.split()[1]]], label)

    # the schedule's padded plans beside their routed trees compiled alone,
    # and the dead-relay plan padded to the largest shape of the run
    pairs = [(compile_plan(sched.raw_at(r)), sched.plan_at(r))
             for r in (0, min(LINK_EVENTS))]
    dead = topo.plan(dead=(0,))
    pairs.append((dead, dead.pad((max(dead.shape[0], sched.shape[0]),
                                  max(dead.shape[1], sched.shape[1])))))
    for label in ("cl_sia failure", "sia failure"):
        padded_equals_unpadded(sims[label], pairs, label.split()[0])
    if not any(float(b.slot_mask.min()) == 0.0 for _, b in pairs):
        raise SystemExit("FAIL no padded lane reached the kernels")

    profile_rounds(sims["cl_sia failure"], "cl_sia walker tree", None)
    profile_rounds(chain, "cl_sia chain (phase 6)", None)
    return launches


# ---------------------------------------------------------------------------
# phase 7: multi-tenant cohort rounds
# ---------------------------------------------------------------------------

COHORT_SEEDS = tuple(SEED + i for i in range(8))   # B = 8 cohorts
BATCHED_ROUNDS = 10           # the walker run re-routes at 2 and back at 8
SCALING_COHORTS = (1, 2, 4, 8)
SCALING_ROUNDS = 5
# the runs compared card against CPU, and their rounds
BATCHED_CMP = {"tc_sia star": (0, 1, 2), "cl_tc_sia walker": (1, 2, 3),
               "tc_sia scan": (0, 1, 2), "tc_sia hist": (0, 1, 2)}


def batched_runs(pc, k):
    """(label, AggConfig keywords, Simulator keywords, run keywords, the
    plan of round r, level-kernel launches per level) of phase 7."""
    from repro_torch.agg import compile_plan
    from repro_torch.core.algorithms import AggKind
    from repro_torch.fed.topology import FailureSchedule, TreeTopology
    from repro_torch.topo import star_tree, walker_delta

    exact = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    thr = dict(exact, topq_impl="threshold", hist_branch=BRANCH)
    chain, star = compile_plan(k), compile_plan(star_tree(k))
    topo = TreeTopology(walker_delta(**WALKER), "widest")
    fails = FailureSchedule(k, FAILURES)
    tc = dict(sparsify_ef_level=1, chain_accum_level=1)
    tc_exact = dict(kind=AggKind.TC_SIA, **exact)
    cl_tc = dict(kind=AggKind.CL_TC_SIA, **exact)
    return [
        ("tc_sia chain", tc_exact, {}, {}, lambda r: chain, tc),
        ("tc_sia star", tc_exact, {}, dict(topology=star_tree(k)),
         lambda r: star, tc),
        ("cl_tc_sia chain", cl_tc, {}, {}, lambda r: chain,
         dict(cl_fuse_level=1)),
        ("cl_tc_sia star", cl_tc, {}, dict(topology=star_tree(k)),
         lambda r: star, dict(cl_fuse_level=1)),
        ("cl_tc_sia walker", cl_tc, dict(tree_topology=topo),
         dict(failure_schedule=fails),
         lambda r: topo.plan(dead=tuple(fails.dead_at(r))),
         dict(cl_fuse_level=1)),
        ("tc_sia scan", dict(kind=AggKind.TC_SIA, **thr, **THRESHOLD["scan"]),
         {}, {}, lambda r: chain,
         dict(tc, count_ge_fused_level=THRESHOLD["scan"]["hist_rounds"])),
        ("tc_sia hist", dict(kind=AggKind.TC_SIA, **thr, **THRESHOLD["hist"]),
         {}, {}, lambda r: chain, dict(tc, hist_topq_level=1)),
    ]


def batched_card_matches_cpu(sim_card, sim_cpu, plans, label: str):
    """Batched rounds over ``plans``, both simulators fed the CPU's
    gradients of every cohort: model, EF rows, bits and nnz bit for bit,
    the loss to rtol 1e-4."""
    from repro_torch.data.federated import client_minibatch

    gens = [torch.Generator().manual_seed(s) for s in COHORT_SEEDS]
    s_cpu = sim_cpu.init_batched(COHORT_SEEDS)
    s_card = sim_card.init_batched(COHORT_SEEDS)
    worst = 0.0
    for r, plan in enumerate(plans):
        grads = []
        for i, gen in enumerate(gens):
            bx, by = client_minibatch(sim_cpu.fed, sim_cpu.pc.batch_size, gen)
            grads.append(sim_cpu.client_grads(s_cpu.flat_w[i], bx, by))
        grads = torch.stack(grads)
        s_cpu, l_cpu = sim_cpu.aggregate_step_batched(s_cpu, plan, grads)
        s_card, l_card = sim_card.aggregate_step_batched(s_card, plan,
                                                         grads.cuda())
        same = all(bitwise_equal(u, v) for u, v in (
            (s_cpu.flat_w, s_card.flat_w), (s_cpu.ef, s_card.ef),
            (l_cpu.stats[0].bits, l_card.stats[0].bits),
            (l_cpu.stats[0].nnz_out, l_card.stats[0].nnz_out)))
        rel = float(((l_card.loss.cpu() - l_cpu.loss).abs()
                     / l_cpu.loss.abs()).max())
        worst = max(worst, rel)
        if not same or rel > 1e-4:
            raise SystemExit(f"FAIL {label} batched round {r} (plan "
                             f"{plan.shape}): card and CPU differ "
                             f"(state/bits equal: {same}, loss rel "
                             f"{rel:.2e})")
    log(f"[batched] {label}: {len(plans)} rounds of {len(COHORT_SEEDS)} "
        f"cohorts over plans {[p.shape for p in plans]} on the card vs the "
        f"CPU with the same gradients: model, EF rows, bits and nnz bit for "
        f"bit; loss max rel diff {worst:.2e}")


def scheduler_buckets(cfg, k: int, d: int):
    """A RoundScheduler on the card fed three submits of a chain, a star
    and a routed Walker tree (one K = 28 bucket, padded to its running
    maximum) and a K = 4 chain (a second bucket): each cohort's result
    equals a sequential ``execute`` on its own plan, and the scheduler
    meets no more input signatures than it launched buckets."""
    from repro_torch.agg import (CohortRound, RoundScheduler, compile_plan,
                                 execute)
    from repro_torch.fed.topology import TreeTopology
    from repro_torch.topo import star_tree, walker_delta

    walker = TreeTopology(walker_delta(**WALKER), "widest").plan()
    plans = [compile_plan(k), compile_plan(star_tree(k)), walker,
             compile_plan(4)]
    sched = RoundScheduler(cfg)
    rng = np.random.default_rng(SEED + 70)
    for sub in range(3):
        rounds = []
        for i, plan in enumerate(plans):
            kk = plan.num_clients
            t = lambda a: torch.from_numpy(  # noqa: E731
                np.asarray(a, np.float32)).cuda()
            rounds.append(CohortRound(
                (sub, i), plan, t(rng.standard_normal((kk, d)) * 0.01),
                t(rng.standard_normal((kk, d)) * 1e-3),
                t(rng.uniform(0.5, 1.5, kk)),
                t(rng.random(d) < 0.01), t(rng.random(kk) < 0.9)))
        got = sched.submit(rounds)
        for r in rounds:
            want = execute(cfg, r.plan, r.grads, r.e, r.weights,
                           global_mask=r.global_mask,
                           participate=r.participate)
            res = got[r.cohort_id]
            if not all(bitwise_equal(u, v) for u, v in (
                    (want.aggregate, res.aggregate),
                    (want.e_new, res.e_new),
                    (want.stats.nnz_out, res.stats.nnz_out),
                    (want.stats.bits, res.stats.bits))):
                raise SystemExit(f"FAIL scheduler cohort {r.cohort_id} "
                                 f"(plan {r.plan.shape}) differs from "
                                 f"sequential execute")
    sched.assert_bucket_specializations()
    if sched.trace_counter.count != 2:
        raise SystemExit(f"FAIL the scheduler met "
                         f"{sched.trace_counter.count} input signatures "
                         f"for 2 buckets")
    log(f"[batched] RoundScheduler on the card: 3 submits of chain, star, "
        f"Walker tree (K = {k}) and a K = 4 chain; buckets "
        f"{[(e['key'][0], e['shape'], e['padded_cohorts']) for e in sched.bucket_log[:2]]}"
        f"; {sched.trace_counter.count} specializations for "
        f"{sched.expected_specializations} buckets; every cohort equal to "
        f"sequential execute bit for bit")


def batched_path(level, data) -> dict:
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.fed import Simulator

    pc, fed, test = data
    k = pc.num_clients
    runs = batched_runs(pc, k)
    sims = {label: Simulator(pc, AggConfig(**cfg), fed, device="cuda", **skw)
            for label, cfg, skw, _, _, _ in runs}
    b = len(COHORT_SEEDS)
    t0 = time.perf_counter()
    for label, _, _, rkw, _, _ in runs:
        sims[label].run_batched(2, seeds=COHORT_SEEDS, **rkw)
        sims[label].run(1, seed=SEED, **rkw)
    torch.cuda.synchronize()
    log(f"[batched] warm-up: {time.perf_counter() - t0:.1f} s")

    names = [fn.__name__.replace("_cuda", "") for fn in level.KERNELS]
    level.reset_launch_counts()
    torch.cuda.synchronize()
    results, per_round = {}, {}
    for label, _, _, rkw, plan_of, per_level in runs:
        before = [fn.launches for fn in level.KERNELS]
        t0 = time.perf_counter()
        out = sims[label].run_batched(BATCHED_ROUNDS, seeds=COHORT_SEEDS,
                                      test_x=test.x, test_y=test.y,
                                      eval_every=BATCHED_ROUNDS, **rkw)
        torch.cuda.synchronize()
        per_round[label] = 1e3 * (time.perf_counter() - t0) / BATCHED_ROUNDS
        grown = {n: fn.launches - c for n, fn, c in
                 zip(names, level.KERNELS, before)}
        levels = sum(plan_of(r).shape[0] for r in range(BATCHED_ROUNDS))
        want = {n: levels * per_level.get(n, 0) for n in names}
        if grown != want:
            raise SystemExit(f"FAIL batched {label}: level-kernel launches "
                             f"{grown}, predicted {want} (one per level for "
                             f"all {b} cohorts)")
        results[label] = out
        loss = np.asarray(out["loss"])
        log(f"[batched] {label:16s} B={b}: loss {loss[0].mean():.4f} -> "
            f"{loss[-1].mean():.4f} (cohort mean), acc "
            f"{np.mean(out['accuracy'][-1][1]):.3f}, bits/round/cohort "
            f"{np.mean(out['bits']):.0f}, {per_round[label]:.2f} ms per "
            f"batched round (host clock, synchronized); launches "
            f"{ {n: v for n, v in grown.items() if v} } = "
            f"{levels / BATCHED_ROUNDS:.1f} levels per round")
    launches = {n: fn.launches for n, fn in zip(names, level.KERNELS)}
    log(f"[batched] launches over the batched runs: {launches}")
    for name in ("cl_fuse_level", "sparsify_ef_level", "chain_accum_level",
                 "count_ge_fused_level", "hist_topq_level"):
        if launches[name] <= 0:
            raise SystemExit(f"FAIL {name} was never launched on the "
                             f"batched path")

    for label, _, _, rkw, _, _ in runs:
        out = results[label]
        loss = np.asarray(out["loss"])
        if not (np.isfinite(loss).all() and (loss[-1] < loss[0]).all()):
            raise SystemExit(f"FAIL batched {label}: loss did not fall in "
                             f"every cohort ({loss[0]} -> {loss[-1]})")
        st = out["state"]
        for i, seed in enumerate(COHORT_SEEDS):
            ref = sims[label].run(BATCHED_ROUNDS, seed=seed, **rkw)
            same = (bitwise_equal(st.flat_w[i], ref["state"].flat_w)
                    and bitwise_equal(st.ef[i], ref["state"].ef)
                    and [row[i] for row in out["bits"]] == ref["bits"]
                    and [row[i] for row in out["nnz"]] == ref["nnz"])
            if not same:
                raise SystemExit(f"FAIL batched {label}: cohort {i} differs "
                                 f"from run(seed={seed}) on the card")
    log(f"[batched] every cohort of every batched run equals the sequential "
        f"run(seed) on the card bit for bit: model, EF rows, bits and nnz "
        f"over {BATCHED_ROUNDS} rounds")

    for label, cfg, skw, _, plan_of, _ in runs:
        if label in BATCHED_CMP:
            batched_card_matches_cpu(
                sims[label], Simulator(pc, AggConfig(**cfg), fed,
                                       device="cpu", **skw),
                [plan_of(r) for r in BATCHED_CMP[label]], label)

    scheduler_buckets(AggConfig(**runs[0][1]), k, pc.d)

    # one batched round against B sequential rounds, B = 1, 2, 4, 8
    for label in ("tc_sia chain", "cl_tc_sia walker"):
        rkw = next(r[3] for r in runs if r[0] == label)
        sim = sims[label]
        cells = []
        for nb in SCALING_COHORTS:
            seeds = COHORT_SEEDS[:nb]
            t0 = time.perf_counter()
            sim.run_batched(SCALING_ROUNDS, seeds=seeds, **rkw)
            torch.cuda.synchronize()
            batched = 1e3 * (time.perf_counter() - t0) / SCALING_ROUNDS
            t0 = time.perf_counter()
            for seed in seeds:
                sim.run(SCALING_ROUNDS, seed=seed, **rkw)
            torch.cuda.synchronize()
            seq = 1e3 * (time.perf_counter() - t0) / SCALING_ROUNDS
            cells.append(f"B={nb}: batched {batched:.2f} ms, {nb} sequential "
                         f"{seq:.2f} ms ({seq / batched:.2f}x)")
        log(f"[batched] {label}, one batched round vs B sequential rounds "
            f"(host clock, synchronized, {SCALING_ROUNDS} rounds each): "
            + "; ".join(cells))
    for label in ("tc_sia chain", "cl_tc_sia walker", "tc_sia scan"):
        rkw = next(r[3] for r in runs if r[0] == label)
        sim = sims[label]
        profile_calls(f"batched {label} B={b}", lambda: sim.run_batched(
            3, seeds=COHORT_SEEDS, **rkw), 3)
    return launches


# ---------------------------------------------------------------------------
# phase 8: nested (staged) plans, the trace collector and scenarios
# ---------------------------------------------------------------------------

NESTED_ROUNDS = 20
NESTED_SHORT = 3                  # the threshold runs
STAGE_WS = (1, 2, 4)              # an upper stage's lanes: the pod heads
NESTED_CMP_ROUNDS = 3
TIMING_TURNS = 5                  # turns of the collector/flat timing
PHASE8_DIR = Path(__file__).resolve().parent / "build" / "phase8"


def check_stage_kernels(level, ref, sp, d: int = 7850):
    """Rows 1–5 at an upper stage's shapes (W = 1, 2, 4 lanes), ``g`` the
    sink rows k..k+W−1 of a larger inbox, every variant bit for bit
    against the plain version on the CPU."""
    cuda_fns = {"cl_fuse_level": level.cl_fuse_level_cuda,
                "sparsify_ef_level": level.sparsify_ef_level_cuda,
                "chain_accum_level": level.chain_accum_level_cuda,
                "count_ge_fused_level": level.count_ge_fused_level_cuda,
                "hist_topq_level": level.hist_topq_level_cuda}
    plain_fns = {"cl_fuse_level": ref.ref_cl_fuse_level,
                 "sparsify_ef_level": ref.ref_sparsify_ef_level,
                 "chain_accum_level": ref.ref_chain_accum_level,
                 "count_ge_fused_level": ref.ref_count_ge_fused_level,
                 "hist_topq_level": ref.ref_hist_topq_level}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    n = 0
    for w in STAGE_WS:
        x = make_inputs(w, d, SEED + 80 + w)
        k = 28 + w                     # the sink rows of a stage's inbox
        inbox = np.zeros((k + w + 1, d), np.float32)
        inbox[k:k + w] = x["g"]
        cpu = {key: torch.from_numpy(v) for key, v in x.items()}
        cpu["g"] = torch.from_numpy(inbox)[k:k + w]
        gpu = {key: v.to(dev) for key, v in cpu.items()}
        gpu["g"] = torch.from_numpy(inbox).to(dev)[k:k + w]
        for name, opt in variants():
            got = call(cuda_fns, name, gpu, opt)
            torch.cuda.synchronize()
            want = call(plain_fns, name, cpu, opt)
            if not all(bitwise_equal(a, b) for a, b in zip(want, got)):
                raise SystemExit(f"FAIL {name} {opt} at the stage shape "
                                 f"W={w} d={d}: kernel differs from its "
                                 f"plain version")
            n += 1
        for name, opt in tau_variants(False):
            if name == "count_ge_level" or opt.get("edges") \
                    or opt.get("specials"):
                continue
            tables = tau_tables(sp, ref, cpu, opt, opt.get("branch", BRANCH))
            aux = {"tables": tables}
            aux_gpu = {"tables": tuple(u.to(dev) for u in tables)}
            got = call_tau(cuda_fns, name, gpu, opt, aux_gpu)
            torch.cuda.synchronize()
            want = call_tau(plain_fns, name, cpu, opt, aux)
            if not all(bitwise_equal(a, b) for a, b in zip(want, got)):
                raise SystemExit(f"FAIL {name} {opt} at the stage shape "
                                 f"W={w} d={d}: kernel differs from its "
                                 f"plain version")
            n += 1
    log(f"[nested] rows 1-5 at the upper stages' shapes W = {STAGE_WS}, "
        f"d = {d}, g a view of sink rows inside the inbox: {n} variants "
        f"bit for bit equal to the plain CPU versions "
        f"({time.perf_counter() - t0:.1f} s)")


def nested_runs(pc, k):
    """(label, AggConfig keywords, Simulator keywords, rounds, the nested
    plan, level-kernel launches per level) of phase 8."""
    from repro_torch.agg import compile_nested, pod_ring_nested
    from repro_torch.core.algorithms import AggKind
    from repro_torch.topo import cluster_routed, walker_delta

    exact = dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)
    thr = dict(exact, topq_impl="threshold", hist_branch=BRANCH)
    pods = pod_ring_nested(4, 7)
    walker = compile_nested(cluster_routed(walker_delta(**WALKER), 4),
                            num_clients=k)
    tc = dict(sparsify_ef_level=1, chain_accum_level=1)
    return [
        ("cl_sia pods", dict(kind=AggKind.CL_SIA, **exact), pods,
         NESTED_ROUNDS, dict(cl_fuse_level=1)),
        ("cl_tc_sia walker", dict(kind=AggKind.CL_TC_SIA, **exact), walker,
         NESTED_ROUNDS, dict(cl_fuse_level=1)),
        ("sia walker", dict(kind=AggKind.SIA, **exact), walker,
         NESTED_ROUNDS, tc),
        ("tc_sia scan walker",
         dict(kind=AggKind.TC_SIA, **thr, **THRESHOLD["scan"]), walker,
         NESTED_SHORT,
         dict(tc, count_ge_fused_level=THRESHOLD["scan"]["hist_rounds"])),
        ("tc_sia hist walker",
         dict(kind=AggKind.TC_SIA, **thr, **THRESHOLD["hist"]), walker,
         NESTED_SHORT, dict(tc, hist_topq_level=1)),
    ]


def stage_bits_ok(kind, plan_meta, stage_bits, pc) -> tuple:
    """(within?, closed form or bound per stage) for one round's per-stage
    bits: CL-SIA equals its staged closed form over each stage's live
    units; CL-TC-SIA stays within its closed form (the TCS mask holds
    fewer than Q_G nonzeros while the model barely moves, as in round 0);
    SIA and TC-SIA stay under the staged Prop-2 bound of each stage's
    recorded subtree sizes (2 % slack: it bounds the expected count, as the
    report's check reads it)."""
    from repro_torch.core import comm_cost as cc
    from repro_torch.core.algorithms import AggKind
    from repro_torch.obs.record import subtree_sizes_from_parent

    alive = [int(round(sum(st["alive"]))) for st in plan_meta["stages"]]
    if kind == AggKind.CL_SIA:
        want = cc.nested_cl_sia_bits(alive, pc.d, pc.q)
        return list(stage_bits) == list(want), want
    if kind == AggKind.CL_TC_SIA:
        want = cc.nested_cl_tc_sia_bits(alive, pc.d, pc.q_global, pc.q_local)
        return all(b <= w for b, w in zip(stage_bits, want)), want
    sizes = [subtree_sizes_from_parent(st["parent"])
             for st in plan_meta["stages"]]
    qg, ql = ((pc.q_global, pc.q_local) if kind == AggKind.TC_SIA
              else (0, pc.q))
    want = cc.nested_tc_sia_bits_bound(sizes, pc.d, qg, ql)
    return all(b <= 1.02 * w for b, w in zip(stage_bits, want)), want


def nested_card_matches_cpu(sim_card, sim_cpu, plan, label: str):
    """Nested rounds, both simulators fed the CPU's gradients: model, EF
    rows, every stage EF tier and every stage's bits and counts bit for
    bit, the loss to rtol 1e-4."""
    from repro_torch.data.federated import client_minibatch

    gen = torch.Generator().manual_seed(SEED)
    s_cpu, s_card = sim_cpu.init(), sim_card.init()
    worst = 0.0
    for r in range(NESTED_CMP_ROUNDS):
        bx, by = client_minibatch(sim_cpu.fed, sim_cpu.pc.batch_size, gen)
        grads = sim_cpu.client_grads(s_cpu.flat_w, bx, by)
        s_cpu, l_cpu = sim_cpu.aggregate_step(s_cpu, plan, grads)
        s_card, l_card = sim_card.aggregate_step(s_card, plan, grads.cuda())
        pairs = [(s_cpu.flat_w, s_card.flat_w), (s_cpu.ef, s_card.ef)]
        pairs += list(zip(s_cpu.stage_ef, s_card.stage_ef))
        pairs += [(getattr(a, f), getattr(b, f))
                  for a, b in zip(l_cpu.stats, l_card.stats)
                  for f in ("bits", "nnz_out", "nnz_global", "nnz_local")]
        same = (len(s_cpu.stage_ef) == len(s_card.stage_ef) > 0
                and all(bitwise_equal(u, v) for u, v in pairs))
        rel = abs(float(l_card.loss) - float(l_cpu.loss)) / abs(
            float(l_cpu.loss))
        worst = max(worst, rel)
        if not same or rel > 1e-4:
            raise SystemExit(f"FAIL {label} nested round {r}: card and CPU "
                             f"differ (state/tiers/bits equal: {same}, loss "
                             f"rel {rel:.2e})")
    log(f"[nested] {label}: {NESTED_CMP_ROUNDS} rounds over "
        f"{plan.shape} on the card vs the CPU with the same gradients: "
        f"model, EF rows, {len(s_card.stage_ef)} stage EF tier(s), every "
        f"stage's bits and counts bit for bit; loss max rel diff "
        f"{worst:.2e}")


def walker_scenario(pc):
    """The clustered Walker shell under a relay crash and a link flap:
    the relay is a client with children in its cluster's routed tree, the
    flap the PS's ground link to gateway 1."""
    from repro_torch.scenario import Crash, LinkFlap, Scenario, TopologySpec
    from repro_torch.topo import cluster_routed, walker_delta
    from repro_torch.topo.tree import PS

    nt = cluster_routed(walker_delta(**WALKER), 4)
    relay = next(members[p] for members, tree in zip(nt.clusters, nt.intra)
                 for p in tree.parent if p != PS)
    return Scenario(
        name="walker-clusters-crash-flap", rounds=NESTED_ROUNDS, seed=SEED,
        topology=TopologySpec(
            kind="walker_delta", clients=pc.num_clients, clusters=4,
            params={"num_planes": WALKER["num_planes"],
                    "sats_per_plane": WALKER["sats_per_plane"],
                    "gateways": list(WALKER["gateways"])}),
        agg={"kind": "cl_sia", "q": pc.q},
        crashes=(Crash(node=int(relay), round=6, recover=12),),
        link_flaps=(LinkFlap(link=(0, WALKER["gateways"][0]), start=9,
                             down=5),))


def scenario_run(pc, fed, spec, path: Path):
    """One run of ``spec`` on the card under a TraceCollector → (curves,
    round records, simulator)."""
    from repro_torch.fed import Simulator
    from repro_torch.obs import TraceCollector, iter_trace

    sim = Simulator(pc, spec.agg_config(), fed, device="cuda")
    with TraceCollector(str(path)) as col:
        out = sim.run(spec.rounds, scenario=spec, collector=col,
                      flush_every=8)
    recs = [r for r in iter_trace(str(path)) if r["kind"] == "round"]
    return out, recs, sim


def nested_path(level, ref, sp, data) -> dict:
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.fed import Simulator
    from repro_torch.fed.topology import TreeTopology
    from repro_torch.obs import TraceCollector, iter_trace, validate_trace
    from repro_torch.obs.report import closed_form_check, load_trace
    from repro_torch.scenario import compile_scenario, scenario_from_trace
    from repro_torch.topo import walker_delta

    pc, fed, test = data
    k = pc.num_clients
    t_phase = time.perf_counter()
    check_stage_kernels(level, ref, sp)
    PHASE8_DIR.mkdir(parents=True, exist_ok=True)
    runs = nested_runs(pc, k)
    sims = {label: Simulator(pc, AggConfig(**cfg), fed, device="cuda",
                             nested_topology=plan)
            for label, cfg, plan, _, _ in runs}
    spec = walker_scenario(pc)
    compiled = compile_scenario(spec)
    t0 = time.perf_counter()
    for label, _, _, _, _ in runs:
        sims[label].run(2, seed=SEED)
    torch.cuda.synchronize()
    log(f"[nested] plans: "
        + ", ".join(f"{label} {plan.shape}" for label, _, plan, _, _ in runs)
        + f"; warm-up {time.perf_counter() - t0:.1f} s")

    names = [fn.__name__.replace("_cuda", "") for fn in level.KERNELS]
    level.reset_launch_counts()
    torch.cuda.synchronize()
    stage_logs = {}
    for label, cfg, plan, rounds, per_level in runs:
        before = [fn.launches for fn in level.KERNELS]
        path = PHASE8_DIR / f"{label.replace(' ', '_')}.jsonl"
        t0 = time.perf_counter()
        with TraceCollector(str(path)) as col:
            out = sims[label].run(rounds, seed=SEED, test_x=test.x,
                                  test_y=test.y, eval_every=rounds,
                                  collector=col)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / rounds
        grown = {n: fn.launches - b for n, fn, b in
                 zip(names, level.KERNELS, before)}
        levels = rounds * sum(st.shape[0] for st in plan.stages)
        want = {n: levels * per_level.get(n, 0) for n in names}
        if grown != want:
            raise SystemExit(f"FAIL nested {label}: level-kernel launches "
                             f"{grown}, predicted {want} (Σ over rounds of "
                             f"Σ_s L_s)")
        recs = [r for r in iter_trace(str(path)) if r["kind"] == "round"]
        worst = []
        for rec in recs:
            bits = [sum(st["bits"]) for st in rec["stages"]]
            ok, bound = stage_bits_ok(cfg["kind"], rec["plan"], bits, pc)
            if not ok:
                raise SystemExit(f"FAIL nested {label} round "
                                 f"{rec['round']}: per-stage bits {bits}, "
                                 f"closed form / bound {bound}")
            worst.append([b / w for b, w in zip(bits, bound)])
        loss = out["loss"]
        if not (all(math.isfinite(v) for v in loss)
                and loss[-1] < loss[0]):
            raise SystemExit(f"FAIL nested {label}: loss did not fall "
                             f"({loss[0]} -> {loss[-1]})")
        stage_logs[label] = recs
        log(f"[nested] {label:18s}: loss {loss[0]:.4f} -> {loss[-1]:.4f}, "
            f"acc {out['accuracy'][-1][1]:.3f}, bits per stage "
            f"{[sum(st['bits']) for st in recs[-1]['stages']]} (closed form "
            f"/ bound share max {np.max(worst, axis=0).round(4).tolist()}), "
            f"{ms:.2f} ms/round with the collector (flush every 32); "
            f"launches { {n: v for n, v in grown.items() if v} } = "
            f"{levels // rounds} levels per round")

    # the scenario: a relay crash and a ground-link flap on the clustered
    # Walker shell, recorded, checked and replayed from its own trace
    before = [fn.launches for fn in level.KERNELS]
    trace = PHASE8_DIR / "scenario.jsonl"
    out, recs, sim = scenario_run(pc, fed, spec, trace)
    torch.cuda.synchronize()
    grown = {n: fn.launches - b for n, fn, b in
             zip(names, level.KERNELS, before)}
    levels = sum(st.shape[0] for r in range(spec.rounds)
                 for st in compiled.schedule.plan_at(r).stages)
    if grown != {n: levels if n == "cl_fuse_level" else 0 for n in names}:
        raise SystemExit(f"FAIL nested scenario: launches {grown}, "
                         f"predicted {levels} cl_fuse_level")
    launches = {n: fn.launches for n, fn in zip(names, level.KERNELS)}
    res = validate_trace(str(trace))
    meta, rounds, _ = load_trace(str(trace))
    check = closed_form_check(meta, rounds)
    full = sum(1 for r in rounds if all(p > 0 for p in r["participation"]))
    if (res["errors"] or check is None or check["rounds_checked"]
            != spec.rounds or check["matches"] != full
            or check["worst_abs_gap_bits"] != 0.0):
        raise SystemExit(f"FAIL nested scenario trace: validation "
                         f"{res['errors'][:3]}, closed-form check {check} "
                         f"({full} full-participation rounds)")
    if sim.trace_counter.count != 1:
        raise SystemExit(f"FAIL nested scenario: "
                         f"{sim.trace_counter.count} input signatures")
    replay_spec, _ = scenario_from_trace(str(trace))
    _, replay, _ = scenario_run(pc, fed, replay_spec,
                                PHASE8_DIR / "replay.jsonl")
    fields = lambda r: ([st["bits"] for st in r["stages"]],  # noqa: E731
                        [st["nnz"] for st in r["stages"]], r["loss"],
                        r["participation"])
    if [fields(r) for r in recs] != [fields(r) for r in replay]:
        raise SystemExit("FAIL nested scenario: the replay from the trace "
                         "gave other round records")
    stubs = sorted({r["round"] for r in recs
                    if min(r["plan"]["stages"][1]["alive"]) == 0})
    log(f"[nested] scenario {spec.name}: {len(compiled.events)} events "
        f"({', '.join(e['name'] for e in compiled.events)}), "
        f"{len(compiled.schedule.plans)} plans of shape "
        f"{compiled.schedule.shape}, stub-cluster rounds {stubs}; trace "
        f"valid ({ {k_: v for k_, v in res.items() if k_ != 'errors'} }), "
        f"closed form exact in {check['rounds_checked']} rounds (worst gap "
        f"{check['worst_abs_gap_bits']}), {check['matches']} with full "
        f"participation; 1 input signature; the replay from the trace "
        f"gives the same bits, nnz, loss and participation in every round; "
        f"launches {levels} cl_fuse_level (Σ_r Σ_s L_s)")

    for label in ("cl_sia pods", "sia walker", "tc_sia scan walker"):
        cfg, plan = next((c, p) for lb, c, p, _, _ in runs if lb == label)
        nested_card_matches_cpu(
            sims[label], Simulator(pc, AggConfig(**cfg), fed, device="cpu",
                                   nested_topology=plan), plan, label)

    # ms per round: the collector off, flushing every round and every 32
    # rounds, and the flat Walker tree round, in turns (host speed drifts
    # within a run), each order reversed on the next turn; medians
    sim = sims["cl_sia pods"]
    flat = Simulator(pc, AggConfig(**runs[0][1]), fed, device="cuda",
                     tree_topology=TreeTopology(walker_delta(**WALKER),
                                                "widest"))
    flat.run(1, seed=SEED)

    def with_collector(cadence):
        path = PHASE8_DIR / f"flush_{cadence}.jsonl"
        with TraceCollector(str(path)) as col:
            sim.run(NESTED_ROUNDS, seed=SEED, collector=col,
                    flush_every=cadence)

    cases = {"collector off": lambda: sim.run(NESTED_ROUNDS, seed=SEED),
             "flush every round": lambda: with_collector(1),
             "flush every 32": lambda: with_collector(32),
             "flat Walker tree": lambda: flat.run(NESTED_ROUNDS, seed=SEED)}
    times = {name: [] for name in cases}
    for turn in range(TIMING_TURNS):
        order = list(cases) if turn % 2 == 0 else list(cases)[::-1]
        for name in order:
            t0 = time.perf_counter()
            cases[name]()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0)
                               / NESTED_ROUNDS)
    med = {name: float(np.median(v)) for name, v in times.items()}
    log(f"[nested] cl_sia pods ms per round (host clock, synchronized, "
        f"{NESTED_ROUNDS} rounds, median of {TIMING_TURNS} turns [min, "
        f"max]): " + "; ".join(
            f"{name} {med[name]:.2f} [{min(v):.2f}, {max(v):.2f}]"
            for name, v in times.items())
        + f"; flush 32 / off {med['flush every 32'] / med['collector off']:.3f}"
        f", flush 1 / off {med['flush every round'] / med['collector off']:.3f}"
        f", nested / flat tree "
        f"{med['collector off'] / med['flat Walker tree']:.3f}")
    profile_calls("nested cl_sia pods", lambda: sim.run(3, seed=SEED), 3)
    profile_calls("nested cl_tc_sia walker",
                  lambda: sims["cl_tc_sia walker"].run(3, seed=SEED), 3)
    profile_calls("flat cl_sia walker tree", lambda: flat.run(3, seed=SEED),
                  3)
    log(f"[nested] phase 8: {time.perf_counter() - t_phase:.1f} s")
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
    check_cohort_kernels(level, ref, sp, report)
    report.update(check_scalar_kernels(scalar, ref))
    data = paper_data()
    launches = main_path(level, data)
    launches.update(threshold_path(level, data))
    launches.update(scalar_path(level, scalar))
    for name, n in tree_path(level, data).items():
        launches[name] += n
    for name, n in batched_path(level, data).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in nested_path(level, ref, sp, data).items():
        launches[name] = launches.get(name, 0) + n

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
        large = [x for x in r["shapes"] if x.get("dtype") != "bfloat16"
                 and "cohorts" not in x][-1]
        kernels.append(dict(
            name=name, route="cuda", source=csrc + source[name],
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=large["ms"],
            plain_ms=large["plain_ms"], bound_ms=large["bound_ms"],
            bound_by=large.get("bound_by", "bytes"), library_ms=None,
            max_abs_err_plain_on_card=r["max_abs_err_plain_on_card"],
            variants_checked=r["checked"], shapes=r["shapes"],
            **({"cohort_variants": r["cohort_variants"]}
               if "cohort_variants" in r else {})))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
