"""Card timings of the port's count kernels, one tree against another.

Times ``hist_topq_level`` and ``count_ge_fused_level`` (W = 8, d = 2**23 +
125 and the paper's W = 28, d = 7850; γ_in and a lane-shared global mask;
branch 64), ``count_ge_level`` (the same shapes; 64 shuffled taus per lane
with ±inf, 0 and a tie, and at the large shape also a first scan round's
64 evenly spaced candidates), ``count_ge`` (d = 2**26 + 125 and 7850,
float32 and bfloat16, 64 shuffled taus with −1, 0, +inf and a tie) and
``count_ge_fused`` (the same rows, γ_in on) with CUDA events over
back-to-back launches, on inputs made on the card from a seed. Needs a
CUDA card and nvcc; run from the repository root:

    python3 benchmarks/torch_count_kernels.py ab --old OLD_SRC [--new SRC]
    python3 benchmarks/torch_count_kernels.py ablation [--src SRC]
        [--only hist,count_ge,level_search,level_table]

``ab`` loads the kernels of two trees into one process (each tree's
``repro_torch/kernels/level.py`` built into that tree's ``build/``),
holds their outputs equal on every case and times them in turns, old,
new, new, old, for ten rounds; it prints the medians (at the
paper shapes a call is bound by the host's enqueue, whose time drifts, so
only turns in one process compare), and beside them the device time per
call of the same calls captured in a CUDA graph and replayed, which the
host's enqueue does not reach. ``ablation`` builds
``benchmarks/torch_count_ablation.cu`` (the count kernels cut back step
by step: loads, digits or ranks, atomics, flush) and times its variants
beside the full kernels of the tree under SRC; ``--only`` picks sections
(``level_search``: ``count_ge_level``'s binary-search design at 64 blocks
per lane and at the resident grid; ``level_table``: its rank-table design).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LARGE_LEVEL = (8, 2 ** 23 + 125)
PAPER_LEVEL = (28, 7850)
LARGE_ROW = 2 ** 26 + 125
PAPER_ROW = 7850
BRANCH = 64
SEED = 0
AB_ROUNDS = 10     # rounds of old, new, new, old turns per case


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _check(rc: int):
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


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


def graph_time_ms(fn, calls: int, reps: int) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times (no host enqueue between them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_time_ms(graph.replay, reps) / calls
    del graph
    return ms


def level_inputs(w: int, d: int, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                               device="cuda")
    u = lambda *s: torch.rand(*s, generator=gen,  # noqa: E731
                              device="cuda")
    return dict(g=f(w, d), e=f(w, d) * 0.3, gin=f(w, d) * (u(w, d) < 0.3),
                weight=0.2 + 1.8 * u(w), part=torch.ones(w, device="cuda"),
                gm=(u(d) < 0.1).float())


def hist_tables(sp, ref, t: dict, branch: int = BRANCH):
    op = ref.fused_operand(t["g"], t["e"], t["gin"], t["weight"], t["part"],
                           t["gm"], include_gamma=True)
    hi = torch.clamp(op.abs().amax(-1), min=1e-30) * sp._HI_SCALE
    return sp._hist_tables(torch.zeros_like(hi), hi, branch)


def row_inputs(d: int, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda: torch.randn(d, generator=gen, device="cuda")  # noqa: E731
    x = dict(g=f(), e=f() * 0.3,
             gin=f() * (torch.rand(d, generator=gen, device="cuda") < 0.3))
    rng = np.random.default_rng(seed)
    taus = np.abs(rng.standard_normal(BRANCH)).astype(np.float32) * 1.5
    taus[:4] = [-1.0, 0.0, np.inf, taus[9]]
    x["taus"] = torch.from_numpy(rng.permutation(taus)).cuda()
    return x


def level_taus(w: int, seed: int) -> torch.Tensor:
    """[w, 64] taus in any order with +inf, −inf, 0 and a tie per lane
    (chip_smoke's ``count_ge_level`` taus)."""
    rng = np.random.default_rng(seed)
    taus = np.abs(rng.standard_normal((w, BRANCH))).astype(np.float32)
    taus[:, 5] = taus[:, 9]
    taus[:, 7], taus[:, 8], taus[:, 11] = np.inf, -np.inf, 0.0
    return torch.from_numpy(taus).cuda()


def scan_taus(sp, x: torch.Tensor) -> torch.Tensor:
    """A first scan round's 64 evenly spaced candidates per lane of x."""
    hi = torch.clamp(x.abs().amax(-1), min=1e-30) * sp._HI_SCALE
    return sp._hist_tables(torch.zeros_like(hi), hi, BRANCH)[0].contiguous()


def load_level(src: str, tag: str):
    """→ (module, library): the ``level`` module of the tree under SRC,
    loaded under its own name (it imports no other module of its
    package), with its kernels built."""
    path = Path(src) / "repro_torch" / "kernels" / "level.py"
    spec = importlib.util.spec_from_file_location(f"level_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod, mod._load()


def scratch_words(lib, n: int) -> int:
    # a tree without the rank table keeps sorted taus, places and ranks
    return (lib.count_scratch_words(n) if hasattr(lib, "count_scratch_words")
            else 3 * n + 1)


def row_count(lib, fused: bool, rows: dict, taus, d: int):
    """count_ge (or count_ge_fused with γ_in, w = 1.3, p = 0.6) through
    the tree's C entry."""
    n = taus.numel()
    scratch = torch.empty(scratch_words(lib, n), dtype=torch.int32,
                          device="cuda")
    counts = torch.empty(n, dtype=torch.int32, device="cuda")
    code = int(rows["g"].dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    if fused:
        rc = lib.count_ge_fused_launch(
            rows["g"].data_ptr(), rows["e"].data_ptr(), rows["gin"].data_ptr(),
            None, 1.3, None, 0.6, code, taus.data_ptr(), n,
            scratch.data_ptr(), counts.data_ptr(), d, stream)
    else:
        rc = lib.count_ge_launch(rows["g"].data_ptr(), code,
                                 taus.data_ptr(), n, scratch.data_ptr(),
                                 counts.data_ptr(), d, stream)
    _check(rc)
    return counts


def cases(sp, ref):
    """(name, large, make) for every timed case; make(level, lib) → the
    call of that tree."""
    for tag, (w, d) in (("large", LARGE_LEVEL), ("paper", PAPER_LEVEL)):
        def make(w=w, d=d):
            t = level_inputs(w, d, SEED + w)
            tables = hist_tables(sp, ref, t)
            return lambda level, lib: (lambda: level.hist_topq_level_cuda(
                t["g"], t["e"], t["gin"], t["weight"], t["part"], tables,
                t["gm"], include_gamma=True))
        yield f"hist_topq_level/{tag}", tag == "large", make

        def make(w=w, d=d):
            t = level_inputs(w, d, SEED + w)
            taus = hist_tables(sp, ref, t)[0]
            return lambda level, lib: (
                lambda: level.count_ge_fused_level_cuda(
                    t["g"], t["e"], t["gin"], t["weight"], t["part"], taus,
                    t["gm"], include_gamma=True))
        yield f"count_ge_fused_level/{tag}", tag == "large", make
        for name, scan in ((tag, False),) + ((("scan", True),)
                                             if tag == "large" else ()):
            def make(w=w, d=d, scan=scan):
                x = level_inputs(w, d, SEED + w)["g"]
                taus = scan_taus(sp, x) if scan else level_taus(w, SEED + w)
                return lambda level, lib: (
                    lambda: level.count_ge_level_cuda(x, taus))
            yield f"count_ge_level/{name}", tag == "large", make
    for tag, d in (("large", LARGE_ROW), ("paper", PAPER_ROW)):
        for dt in (torch.float32, torch.bfloat16):
            for fused in (False, True):
                def make(d=d, dt=dt, fused=fused):
                    x = row_inputs(d, SEED + 1)
                    rows = {k: x[k].to(dt) for k in ("g", "e", "gin")}
                    return lambda level, lib: (lambda: row_count(
                        lib, fused, rows, x["taus"], d))
                name = "count_ge_fused" if fused else "count_ge"
                yield (f"{name}/{tag}/{str(dt).replace('torch.', '')}",
                       tag == "large", make)


def ab(old: str, new: str, out_path: str | None) -> int:
    sys.path.insert(0, new)
    from repro_torch.core import sparsify as sp
    from repro_torch.kernels import ref

    trees = {"old": load_level(old, "old"), "new": load_level(new, "new")}
    result = dict(card=nvidia_smi(), old=old, new=new, kernels={},
                  outputs_equal=True)
    for name, large, make in cases(sp, ref):
        bind = make()
        fns = {k: bind(*v) for k, v in trees.items()}
        outs = {}
        for k, fn in fns.items():
            out = fn()
            outs[k] = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["old"],
                                                     outs["new"]))
        result["outputs_equal"] &= same
        times = {"old": [], "new": []}
        graph = {"old": [], "new": []}
        for _ in range(AB_ROUNDS):
            for k in ("old", "new", "new", "old"):
                times[k].append(cuda_time_ms(fns[k], 20 if large else 300))
                graph[k].append(graph_time_ms(fns[k], 10 if large else 50,
                                              3 if large else 10))
        med = {k: float(np.median(v)) for k, v in times.items()}
        gmed = {k: float(np.median(v)) for k, v in graph.items()}
        result["kernels"][name] = dict(
            times, graph_old=graph["old"], graph_new=graph["new"],
            old_median=med["old"], new_median=med["new"],
            speedup=med["old"] / med["new"], graph_old_median=gmed["old"],
            graph_new_median=gmed["new"],
            graph_speedup=gmed["old"] / gmed["new"], outputs_equal=same)
        print(f"[ab] {name}: old {med['old']:.4f} ms, new {med['new']:.4f} "
              f"ms (medians of {2 * AB_ROUNDS} turns each), old/new "
              f"{med['old'] / med['new']:.3f}; in a CUDA graph old "
              f"{gmed['old']:.4f} ms, new {gmed['new']:.4f} ms, old/new "
              f"{gmed['old'] / gmed['new']:.3f}; outputs equal: {same}",
              flush=True)
        del fns, bind, outs
        torch.cuda.empty_cache()
    print(f"[ab] card {result['card']}; outputs of the two trees equal: "
          f"{result['outputs_equal']}")
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(result, indent=1))
    return 0 if result["outputs_equal"] else 1


def build_ablation(level) -> ctypes.CDLL:
    src = ROOT / "benchmarks" / "torch_count_ablation.cu"
    out = level.BUILD_DIR / "libcount_ablation.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([level._nvcc(), *level.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
                    "-I", str(level.CSRC), "-o", str(out), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hist_ablation_launch.argtypes = [i, p, i, p, p, p, p, i, ll, i, p]
    lib.count_ablation_launch.argtypes = [i, i, p, p, i, p, p, ll, p]
    lib.hist_new_ablation_launch.argtypes = lib.hist_ablation_launch.argtypes
    lib.count_new_ablation_launch.argtypes = [i, i, p, p, i, p, p, ll, p]
    lib.level_ablation_launch.argtypes = [i, i, i, p, p, i, p, p, p, i, ll,
                                          i, p]
    lib.level_table_build_launch.argtypes = [p, i, p, i, p]
    lib.level_table_scratch_words.argtypes = [i, i]
    lib.count_scratch_words.argtypes = [i]
    lib.count_ge_launch.argtypes = [p, i, p, i, p, p, ll, p]
    lib.hist_topq_level_launch.argtypes = (
        [p] * 6 + [i] + [p] * 6 + [i, i, ll, p])
    return lib


SECTIONS = ("hist", "count_ge", "level_search", "level_table")


def ablate_level(lib, level, sp, only: set, sink, stream) -> dict:
    """count_ge_level at W = 8, d = 2**23 + 125, shuffled and scan taus:
    the binary-search design at 64 blocks per lane and at the resident
    grid, and the rank-table design (its full time only with
    ``level_table``, so that a run of ``level_search`` alone times no part
    of the present kernel)."""
    w, d = LARGE_LEVEL
    x = level_inputs(w, d, SEED + w)["g"]
    ranks = torch.zeros((w, BRANCH + 1), dtype=torch.int32, device="cuda")
    modes = {0: "a_loads", 1: "b_rank", 3: "d_no_flush", 4: "e_flush"}
    out = {}
    print(f"[ablation] count_ge_level W={w} d={d} B={BRANCH}, "
          f"{math.ceil(d / 8192)} tiles per lane", flush=True)
    x16 = x.to(torch.bfloat16)
    for label, taus in (("any", level_taus(w, SEED + w)),
                        ("scan", scan_taus(sp, x))):
        def launch(design, mode, per_lane, tables=None, taus=taus, x=x):
            _check(lib.level_ablation_launch(
                design, mode, int(x.dtype == torch.bfloat16), x.data_ptr(),
                taus.data_ptr(), BRANCH,
                None if tables is None else tables.data_ptr(),
                ranks.data_ptr(), sink.data_ptr(), w, d, per_lane, stream))
        if "level_search" in only:
            for per_lane in (64, 0):
                for mode, name in modes.items():
                    out[f"{label}/search/{name}/{per_lane or 'resident'}"] = \
                        cuda_time_ms(lambda: launch(0, mode, per_lane), 50)
        if "level_table" in only:
            full = lambda: level.count_ge_level_cuda(x, taus)  # noqa: E731
            out[f"{label}/table/full_first"] = cuda_time_ms(full, 50)
            tables = torch.zeros(lib.level_table_scratch_words(BRANCH, w),
                                 dtype=torch.int32, device="cuda")

            def build():
                _check(lib.level_table_build_launch(
                    taus.data_ptr(), BRANCH, tables.data_ptr(), w, stream))
            out[f"{label}/table/build_kernel"] = cuda_time_ms(build, 50)
            for per_lane in (0, 64):
                for mode, name in {**modes,
                                   8: "e_flush_table_copied"}.items():
                    if mode == 8 and per_lane:
                        continue
                    out[f"{label}/table/{name}/{per_lane or 'resident'}"] = \
                        cuda_time_ms(lambda: launch(1, mode, per_lane,
                                                    tables), 50)
            out[f"{label}/table/full_last"] = cuda_time_ms(full, 50)
            # bfloat16 rows: half the bytes, the same element loop
            out[f"{label}/table/bf16/full"] = cuda_time_ms(
                lambda: level.count_ge_level_cuda(x16, taus), 50)
            for mode, name in modes.items():
                out[f"{label}/table/bf16/{name}/resident"] = cuda_time_ms(
                    lambda: launch(1, mode, 0, tables, x=x16), 50)
    for k, v in out.items():
        print(f"[ablation] count_ge_level {k}: {v:.4f} ms", flush=True)
    return out


def ablation(src: str, out_path: str | None, only: set) -> int:
    sys.path.insert(0, src)
    from repro_torch.core import sparsify as sp
    from repro_torch.kernels import level, ref, topq_threshold

    level.build()
    lib = build_ablation(level)
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    result = dict(card=nvidia_smi(), hist={}, count_ge={})
    print(f"[ablation] card {result['card']}", flush=True)
    if {"level_search", "level_table"} & only:
        result["count_ge_level"] = ablate_level(lib, level, sp, only, sink,
                                                stream)
    if "hist" in only:
        ablate_hist(lib, level, sp, ref, result, sink, stream)
    if "count_ge" in only:
        ablate_count_ge(lib, topq_threshold, result, sink, stream)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(result, indent=1))
    return 0


MODES = {0: "a_loads", 1: "b_d1", 2: "c_d2", 3: "d_no_flush", 4: "e_flush"}


def ablate_hist(lib, level, sp, ref, result, sink, stream):
    modes = MODES
    w, d = LARGE_LEVEL
    t = level_inputs(w, d, SEED + w)
    tables = hist_tables(sp, ref, t)
    full = lambda: level.hist_topq_level_cuda(  # noqa: E731
        t["g"], t["e"], t["gin"], t["weight"], t["part"], tables, t["gm"],
        include_gamma=True)
    d2_real, _ = full()
    nb = BRANCH + 1
    d2 = torch.zeros((w, nb, nb), dtype=torch.int32, device="cuda")
    f = torch.zeros((w, nb), dtype=torch.int32, device="cuda")
    ptrs = [t[k].data_ptr() for k in ("g", "e", "gin", "gm", "weight",
                                      "part")] + [x.data_ptr()
                                                  for x in tables]
    parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    parr_ptr = ctypes.cast(parr, ctypes.c_void_p).value
    n_tiles = math.ceil(d / 8192)
    print(f"[ablation] hist_topq_level W={w} d={d} branch={BRANCH}, "
          f"{n_tiles} tiles per lane; card {result['card']}", flush=True)
    hist = result["hist"]
    hist["full_first"] = cuda_time_ms(full, 50)
    for per_lane in (64, 132, 264):
        for mode, label in modes.items():
            def launch(mode=mode, per_lane=per_lane):
                rc = lib.hist_ablation_launch(
                    mode, parr_ptr, BRANCH, d2_real.data_ptr(), d2.data_ptr(),
                    f.data_ptr(), sink.data_ptr(), w, d, per_lane, stream)
                _check(rc)
            hist[f"{label}/{per_lane}"] = cuda_time_ms(launch, 50)
    for per_lane in (0, 64, 264):
        for mode, label in {**modes, 6: "loop_and_flush",
                            7: "choice_per_element"}.items():
            if mode == 2 or (mode > 4 and per_lane):
                continue

            def launch(mode=mode, per_lane=per_lane):
                rc = lib.hist_new_ablation_launch(
                    mode, parr_ptr, BRANCH, d2_real.data_ptr(), d2.data_ptr(),
                    f.data_ptr(), sink.data_ptr(), w, d, per_lane, stream)
                _check(rc)
            hist[f"present/{label}/{per_lane or 'resident'}"] = cuda_time_ms(
                launch, 50)
    # the present kernel through its C entry, as the wrapper calls it
    gm_shared = 1

    def entry():
        rc = lib.hist_topq_level_launch(
            *ptrs[:3], *ptrs[4:6], ptrs[3], gm_shared, *ptrs[6:],
            d2.data_ptr(), f.data_ptr(), w, BRANCH, d, stream)
        _check(rc)
    hist["present/c_entry"] = cuda_time_ms(entry, 50)
    hist["present/wrapper"] = cuda_time_ms(full, 50)
    hist["full_last"] = cuda_time_ms(full, 50)
    for k, v in hist.items():
        print(f"[ablation] hist {k}: {v:.4f} ms", flush=True)
    del t
    torch.cuda.empty_cache()


def ablate_count_ge(lib, topq_threshold, result, sink, stream):
    modes = MODES
    x = row_inputs(LARGE_ROW, SEED + 1)
    keys = torch.where(torch.isnan(x["taus"]), math.inf, x["taus"])
    sorted_taus = torch.sort(keys).values.contiguous()
    ranks = torch.zeros(BRANCH + 1, dtype=torch.int32, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        row = x["g"].to(dt)
        name = str(dt).replace("torch.", "")
        cg = result["count_ge"][name] = {}
        full = lambda: topq_threshold.count_ge_cuda(row, x["taus"])  # noqa
        cg["full_first"] = cuda_time_ms(full, 50)
        for mode, label in modes.items():
            if mode == 2:
                continue

            def launch(mode=mode):
                rc = lib.count_ablation_launch(
                    mode, int(dt == torch.bfloat16), row.data_ptr(),
                    sorted_taus.data_ptr(), BRANCH, ranks.data_ptr(),
                    sink.data_ptr(), LARGE_ROW, stream)
                _check(rc)
            cg[label] = cuda_time_ms(launch, 50)
        n = BRANCH
        scratch = torch.zeros(lib.count_scratch_words(n), dtype=torch.int32,
                              device="cuda")
        counts = torch.zeros(n, dtype=torch.int32, device="cuda")
        _check(lib.count_ge_launch(
            row.data_ptr(), int(dt == torch.bfloat16), x["taus"].data_ptr(),
            n, scratch.data_ptr(), counts.data_ptr(), LARGE_ROW, stream))
        for mode, label in {**modes, 5: "d_warp_copies"}.items():
            if mode == 2:
                continue

            def launch(mode=mode):
                rc = lib.count_new_ablation_launch(
                    mode, int(dt == torch.bfloat16), row.data_ptr(),
                    scratch.data_ptr(), n, ranks.data_ptr(),
                    sink.data_ptr(), LARGE_ROW, stream)
                _check(rc)
            cg[f"present/{label}"] = cuda_time_ms(launch, 50)
        # a row of equal magnitudes: every element has the same rank
        equal = torch.full_like(row, 0.5)
        for mode, label in ((3, "d_no_flush"), (5, "d_warp_copies")):
            def launch(mode=mode):
                rc = lib.count_new_ablation_launch(
                    mode, int(dt == torch.bfloat16), equal.data_ptr(),
                    scratch.data_ptr(), n, ranks.data_ptr(),
                    sink.data_ptr(), LARGE_ROW, stream)
                _check(rc)
            cg[f"present/{label}/equal_row"] = cuda_time_ms(launch, 50)
        del equal

        def entry():
            rc = lib.count_ge_launch(row.data_ptr(),
                                     int(dt == torch.bfloat16),
                                     x["taus"].data_ptr(), n,
                                     scratch.data_ptr(), counts.data_ptr(),
                                     LARGE_ROW, stream)
            _check(rc)
        cg["present/c_entry"] = cuda_time_ms(entry, 50)
        cg["full_last"] = cuda_time_ms(full, 50)
        for k, v in cg.items():
            print(f"[ablation] count_ge {name} {k}: {v:.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("ab", "ablation"))
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--old")
    ap.add_argument("--new", default=str(ROOT / "src"))
    ap.add_argument("--json")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="ablation sections, comma-separated: "
                         + ", ".join(SECTIONS))
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(SECTIONS):
        ap.error(f"--only takes {', '.join(SECTIONS)}")
    if not torch.cuda.is_available():
        print("no CUDA device; this script times kernels on a GPU",
              file=sys.stderr)
        return 2
    if args.mode == "ab":
        if not args.old:
            ap.error("ab needs --old")
        return ab(os.path.abspath(args.old), os.path.abspath(args.new),
                  args.json)
    return ablation(os.path.abspath(args.src), args.json, only)


if __name__ == "__main__":
    sys.exit(main())
