"""Card timings of exact Top-Q and the compact wire: the crossover between
their two paths, and one tree against another.

``core/sparsify.py``'s ``topq_mask`` (exact Top-Q, lower index first on
ties) and ``compact`` (the first q nonzeros of each row in index order)
have two paths, chosen by row length against ``_SELECT_D``: a stable sort
of the whole operand, and one row at a time through ``topk``'s q-th
magnitude (Top-Q) or the row's nonzero positions (``compact``).
Inputs are float32 (the fused operand's dtype), made on the card from a
seed with ties at many magnitudes, q = d / 100 (78 at the paper's
widths), and ``compact`` gets rows holding q / 2 nonzeros.

``crossover`` times both paths of one tree (``_SELECT_D`` set to force
each) at W = 8 rows of d = 2**14 … 2**24, at the paper's level (W = 28,
d = 7850), a segments-lowering level (W = 28, d = 281) and the LM train
step's phi4-mini lanes (W = 2, d = 204,082,944). ``ab`` times two trees'
``sparsify.py`` (both loaded into one process) at the paper, segments,
W = 8 × 2**23 + 125 and phi4 shapes. Both hold the two sides' outputs
equal on every case and time them in turns (a, b, b, a; five rounds) with
CUDA events around each call and a synchronize on both sides (the
row-at-a-time path syncs per row); each prints one JSON line per case:
the medians and the peak device memory each call added. Needs a CUDA
card; run from the repository root:

    python3 tools/torch_topq_select.py crossover [--src SRC]
    python3 tools/torch_topq_select.py ab --old OLD_SRC [--new SRC]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
PHI4 = ("phi4 train lanes", 2, 204_082_944, 2_040_829)
AB_CASES = (("paper level", 28, 7850, 78), ("segments level", 28, 281, 78),
            ("large level", 8, 2 ** 23 + 125, (2 ** 23 + 125) // 100), PHI4)
CROSSOVER_CASES = (("paper level", 28, 7850, 78),
                   ("segments level", 28, 281, 78)) + tuple(
    (f"W = 8, d = 2^{e}", 8, 2 ** e, 2 ** e // 100)
    for e in (14, 16, 18, 20, 21, 22, 23, 24)) + (PHI4,)
ROUNDS = 5


def load(src: Path, tag: str):
    """``src/repro_torch/core/sparsify.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"sparsify_{tag}", src / "repro_torch" / "core" / "sparsify.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(w: int, d: int, q: int, seed: int) -> tuple:
    """(Top-Q operand with ties at many magnitudes, wire payload with
    q / 2 nonzeros a row)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((w, d), generator=gen, device="cuda")
    x = torch.round(x * 64) / 64
    payload = torch.zeros_like(x)
    pos = torch.randint(0, d, (w, q // 2), generator=gen, device="cuda")
    payload.scatter_(1, pos, torch.randn((w, q // 2), generator=gen,
                                         device="cuda"))
    return x, payload


def timed(fn) -> tuple:
    """(ms, peak bytes above the start) of one call."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return start.elapsed_time(end), peak


def compare(label: str, w: int, d: int, q: int, seed: int, sides: dict):
    """Hold the two sides equal on one case, time them in turns and print
    the JSON line. ``sides``: name → (sparsify module, prepare) where
    ``prepare()`` sets the module up before each call."""
    x, payload = inputs(w, d, q, seed)
    ops = {"topq_mask": lambda sp: sp.topq_mask(x, q),
           "compact": lambda sp: sp.compact(payload, q)}
    (a_name, a), (b_name, b) = sides.items()

    def run(side, call):
        mod, prepare = side
        prepare()
        return call(mod)

    for op, call in ops.items():
        out_a, out_b = run(a, call), run(b, call)
        if op == "topq_mask":
            out_a, out_b = (out_a,), (out_b,)
        if not all(torch.equal(u, v) for u, v in zip(out_a, out_b)):
            raise SystemExit(f"{label} {op}: {a_name} and {b_name} disagree")
        del out_a, out_b
        ms = {a_name: [], b_name: []}
        peak = {a_name: 0, b_name: 0}
        for _ in range(ROUNDS):
            for name in (a_name, b_name, b_name, a_name):
                t, p = timed(lambda: run(sides[name], call))
                ms[name].append(t)
                peak[name] = max(peak[name], p)
        row = dict(case=label, op=op, W=w, d=d, q=q, turns=2 * ROUNDS)
        for name in (a_name, b_name):
            row[f"{name}_ms"] = statistics.median(ms[name])
            row[f"{name}_peak_bytes"] = peak[name]
        print(json.dumps(row), flush=True)
    del x, payload
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    cross = sub.add_parser("crossover")
    cross.add_argument("--src", type=Path, default=ROOT / "src")
    ab = sub.add_parser("ab")
    ab.add_argument("--old", type=Path, required=True)
    ab.add_argument("--new", type=Path, default=ROOT / "src")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_topq_select: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"# device: {card.strip()}", flush=True)
    if args.mode == "crossover":
        sys.path.insert(0, str(args.src))
        sp = load(args.src, "src")

        def force(limit):
            def prepare():
                sp._SELECT_D = limit
            return prepare

        sides = {"sort": (sp, force(1 << 62)), "select": (sp, force(0))}
        for si, case in enumerate(CROSSOVER_CASES):
            compare(*case, si, sides)
        return 0
    sys.path.insert(0, str(args.new))
    sides = {"old": (load(args.old, "old"), lambda: None),
             "new": (load(args.new, "new"), lambda: None)}
    for si, case in enumerate(AB_CASES):
        compare(*case, si, sides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
