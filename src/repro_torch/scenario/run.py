"""Scenario driver — ``python -m repro_torch.scenario.run SPEC`` (port of
:mod:`repro.scenario.run`).

``SPEC`` is a preset name (:mod:`repro_torch.scenario.presets`), a path to
a scenario JSON file (:meth:`~repro_torch.scenario.spec.Scenario.to_json`),
or a path to a previously emitted trace — in which case the spec embedded
in the trace meta is replayed bit-exactly (the trace may come from either
package: the spec schema is the reference's). The scenario is compiled
once, run through the :class:`~repro_torch.fed.simulator.Simulator` on
``--torch-device`` (default ``cuda``), and written as a schema-validated
JSONL trace whose meta carries the spec and whose ``track="scenario"``
spans carry the realized event stream. Exits nonzero if the trace fails
validation or the rounds met more than one input signature.

``--backend`` is ``host`` only: the multi-device backend is ROADMAP A12.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch


def load_spec(ref: str):
    """Resolve a preset name / spec JSON path / trace path to a Scenario."""
    from repro_torch.scenario.presets import PRESETS, preset
    from repro_torch.scenario.spec import Scenario, scenario_from_trace
    if ref in PRESETS:
        return preset(ref)
    if not os.path.exists(ref):
        raise FileNotFoundError(f"{ref}: not a preset "
                                f"({', '.join(sorted(PRESETS))}) and not a "
                                f"file")
    with open(ref) as f:
        head = f.readline()
    try:                    # a JSONL trace has a one-line meta record first
        obj = json.loads(head)
    except json.JSONDecodeError:
        obj = None          # multi-line spec JSON
    if isinstance(obj, dict) and obj.get("kind") == "meta":
        return scenario_from_trace(ref)[0]
    return Scenario.from_json(ref)


def _check_backend(backend: str) -> None:
    if backend != "host":
        raise ValueError(f"backend {backend!r} is not ported: the "
                         f"multi-device backend is ROADMAP A12; use "
                         f"backend='host'")


def run_scenario(spec, *, backend: str = "host", out: str = "trace.jsonl",
                 flush_every: int = 8, device=None) -> dict:
    """Compile + run one scenario on ``device`` (``None`` → ``cuda``); →
    the simulator's curves dict plus the compiled scenario and the input
    signatures the rounds met under ``_scenario``/``_retraces``.

    The data is the reference driver's shape: synthetic MNIST, 40 samples
    per client, seeds 0 (samples) and 2 (the split)."""
    from repro_torch.configs import PAPER
    from repro_torch.data import make_synthetic_mnist, partition_iid
    from repro_torch.fed.simulator import Simulator
    from repro_torch.obs import TraceCollector
    from repro_torch.scenario.compile import compile_scenario

    _check_backend(backend)
    k = spec.num_clients
    pc = dataclasses.replace(PAPER, num_clients=k)
    train = make_synthetic_mnist(0, k * 40, device=device)
    fed = partition_iid(train, k, torch.Generator().manual_seed(2))
    sim = Simulator(pc, spec.agg_config(), fed, local_lr=pc.lr,
                    device=device)
    compiled = compile_scenario(spec, cfg=sim.agg)
    with TraceCollector(out) as col:
        curves = sim.run(spec.rounds, scenario=compiled, collector=col,
                         flush_every=flush_every)
    curves["_scenario"] = compiled
    curves["_retraces"] = sim.trace_counter.count
    return curves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.scenario.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("spec", help="preset name, scenario .json, or a "
                                 "recorded trace to replay")
    ap.add_argument("--out", default="scenario_trace.jsonl",
                    help="output trace path")
    ap.add_argument("--backend", default="host",
                    choices=("host", "device"))
    ap.add_argument("--torch-device", default=None,
                    help="torch device of the rounds (default: cuda)")
    ap.add_argument("--flush-every", type=int, default=8)
    args = ap.parse_args(argv)

    _check_backend(args.backend)
    spec = load_spec(args.spec)
    curves = run_scenario(spec, out=args.out, flush_every=args.flush_every,
                          device=args.torch_device)

    from repro_torch.obs import validate_trace
    from repro_torch.obs.report import print_summary, summarize
    res = validate_trace(args.out)
    errs = list(res.pop("errors"))
    if curves["_retraces"] != 1:
        errs.append(f"{curves['_retraces']} input signatures (want 1)")
    status = "OK" if not errs else "FAIL"
    events = curves["_scenario"].events
    print(f"[{status}] {spec.name}: {spec.rounds} rounds, "
          f"{len(events)} injected events, final loss "
          f"{curves['loss'][-1]:.6f} → {args.out} ({res})")
    for e in errs[:10]:
        print(f"    {e}")
    print_summary(summarize(args.out))
    return 0 if not errs else 1


if __name__ == "__main__":
    sys.exit(main())
