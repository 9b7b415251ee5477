"""Emit the §Roofline table from the port's dry-run JSON (twin of
``emit_experiments_table.py``; the same table, from the records of
``python -m repro_torch.launch.dryrun --all --out dryrun_results.json``).

    python benchmarks/torch_emit_experiments_table.py dryrun_results.json \
        16x16
    python benchmarks/torch_emit_experiments_table.py --port dryrun_results.json

The port's records keep the reference's keys: ``roofline`` (here the
fake run's counts over H100 SXM spec peaks, a model with no card run
behind it) and ``memory_analysis.peak_bytes_estimate``, which the port
measures in its run with one fake device a rank; where no device held one
rank, it reads "not measured". ``--port`` prints the port's own table
instead, bytes only: one row per arch, one column per shape, each cell
with both production meshes side by side (16x16 / 2x16x16): the bytes one
rank holds of the step's arguments and outputs, the port's state (or
serving params and cache) on rank (0, 0)'s device, and its one-device
peak, and one rank's peak estimate where measured; then the cells whose
one-device peak fits a card's 80 GB, and those whose rank peak estimate
does. (On 2x16x16 the ranks from the 256th on share one fake device,
``dryrun.rank_mesh``; rank (0, 0) holds one rank.)
"""

import json
import sys


def main(path="dryrun_results.json", mesh="16x16"):
    with open(path) as f:
        cells = json.load(f)
    rows = [c for c in cells if c.get("mesh") == mesh
            and c.get("status") == "ok"]
    print(f"| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | "
          f"bottleneck | useful | roofline | peak GB/dev |")
    print("|---|---|---|---|---|---|---|---|---|")
    for c in rows:
        r = c["roofline"]
        peak = c["memory_analysis"]["peak_bytes_estimate"]
        peak = "not measured" if peak is None else f"{peak / 1e9:.1f}"
        print(f"| {c['arch']} | {c['shape']} | {r['t_compute_s']:.3g} "
              f"| {r['t_memory_s']:.3g} | {r['t_collective_s']:.3g} "
              f"| {r['bottleneck']} | {r['useful_flops_ratio']:.2f} "
              f"| {r['roofline_fraction']:.4f} | {peak} |")
    fails = [c for c in cells if c.get("status") != "ok"]
    print(f"\n{len(rows)} cells on {mesh}; {len(fails)} failures total.")


def _gb(x):
    return f"{x / 1e9:.4g}"


def port_main(path="dryrun_results.json", meshes=("16x16", "2x16x16")):
    with open(path) as f:
        cells = json.load(f)
    by = {(c["arch"], c["shape"], c["mesh"]): c for c in cells
          if c.get("status") == "ok"}
    archs = list(dict.fromkeys(c["arch"] for c in cells))
    shapes = list(dict.fromkeys(c["shape"] for c in cells))
    print(f"| arch | {' | '.join(shapes)} |")
    print("|---" * (len(shapes) + 1) + "|")
    fits, rank_fits, n = [], [], 0
    for arch in archs:
        row = []
        for shape in shapes:
            got = [by.get((arch, shape, m)) for m in meshes]
            if None in got:
                row.append("–")
                continue
            n += 1

            def col(fn):
                return " / ".join(fn(c) for c in got)

            def rank(c):
                m = c["memory_analysis"]
                return m["argument_size_in_bytes"] + m["output_size_in_bytes"]

            def first(c):
                return c.get("port_device_bytes", [c["port_home_bytes"]])[0]

            text = (f"{col(lambda c: _gb(rank(c)))} · "
                    f"{col(lambda c: _gb(first(c)))} · "
                    f"{col(lambda c: _gb(c['device_peak_bytes']))}")
            est = [c["memory_analysis"]["peak_bytes_estimate"] for c in got]
            if None not in est:
                text += f" · {' / '.join(_gb(e) for e in est)}"
                fit = [m for m, c in zip(meshes, got) if c["fits_one_card"]]
                if fit:
                    rank_fits.append(f"{arch} × {shape} ({', '.join(fit)})")
            row.append(text)
            fit = [m for m, c in zip(meshes, got) if c["port_fits_one_card"]]
            if fit:
                fits.append(f"{arch} × {shape} ({', '.join(fit)})")
        print(f"| {arch} | {' | '.join(row)} |")
    fails = [c for c in cells if c.get("status") != "ok"]
    print()
    if rank_fits:
        print(f"Rank peak estimate within 80 GB: {'; '.join(rank_fits)}.")
    print(f"Each cell: rank args + outs GB · port rank (0, 0) state GB · "
          f"port one-device peak GB (· rank peak estimate GB), on "
          f"{' / '.join(meshes)}. Port one-device peak within 80 GB: "
          f"{'; '.join(fits) or 'none'}.")
    print(f"{n} cells × {len(meshes)} meshes; {len(fails)} failures total.")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--port"]:
        port_main(*sys.argv[2:])
    else:
        main(*sys.argv[1:])
