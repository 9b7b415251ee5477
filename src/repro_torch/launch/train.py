"""Training CLI (port of :mod:`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --smoke --steps 50 --agg cl_sia --ckpt-dir /tmp/ckpt \
        [--mesh 4x1] [--device cpu]

``--mesh`` gives the mesh shape (``DxM`` → (data, model), ``PxDxM`` →
(pod, data, model)). With ``--device`` every rank sits on that device
(``--device cuda:0 --mesh 4x1``: four ranks on one card; ``--device cpu``:
on the CPU); without it each rank takes a card of its own, and the mesh
defaults to one rank per visible card. On a mesh of several devices the
state is placed by rank (``train.step.init_state``). Resumes from the
newest checkpoint in ``--ckpt-dir`` if present, each rank's piece restored
onto its rank's device.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.data.synthetic import lm_batch, make_bigram_lm
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_agg_plan, make_mesh
from repro_torch.models.stubs import audio_stub_embeds, vision_stub_embeds
from repro_torch.optim.optimizers import OptConfig
from repro_torch.runtime.fault import StragglerModel
from repro_torch.train.state import TrainConfig, abstract_like
from repro_torch.train.step import (build_train_step, dp_size, init_state,
                                   state_shardings)


def _topology(name: str, k: int):
    """CLI topology name → something ``compile_plan`` accepts (or None)."""
    if name == "hierarchical":
        # two-stage pod nested plan (needs a pod axis: --mesh PxDxM)
        return "hierarchical"
    if name != "ring" and k <= 2:
        print(f"topology {name!r} needs >2 DP clients (have {k}); "
              f"falling back to the rotated ring")
        name = "ring"
    if name == "ring":
        return None                      # the rotated ring (paper chain)
    if name == "chain":
        return k                         # identity chain, PS at client 0
    from repro_torch.topo import graph as tg
    from repro_torch.topo.tree import star_tree
    if name == "star":
        return star_tree(k)
    rows = max(d for d in range(1, int(k ** 0.5) + 1) if k % d == 0)
    if name == "grid":
        if rows == 1:                    # prime K: a 1×K grid is a path
            print(f"grid needs composite K (have {k}); the 1x{k} grid "
                  f"degenerates to the chain")
        return tg.grid_graph(rows, k // rows)
    if name == "walker-delta":
        if rows == 1:                    # prime K: no orbital planes
            print(f"walker-delta needs composite K (have {k}); using the "
                  f"star topology instead")
            return star_tree(k)
        return tg.walker_delta(rows, k // rows)
    raise ValueError(f"unknown topology {name!r}")


def _mesh(spec: str, device):
    """The mesh of ``--mesh`` (and ``--device``)."""
    if device is not None:
        dev = resolve_device(device)
        shape = tuple(int(x) for x in spec.split("x")) if spec else (1, 1)
        devices = [dev] * math.prod(shape)
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        shape = tuple(int(x) for x in spec.split("x")) if spec else (n, 1)
        devices = None
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return make_mesh(shape, axes, devices)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-arch config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--agg", default="cl_sia",
                    choices=[k.value for k in AggKind if k != AggKind.ROUTING])
    ap.add_argument("--q-frac", type=float, default=0.01)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x2 → (data=2, model=2); default one rank "
                         "per card, or one rank on --device")
    ap.add_argument("--topology", default="ring",
                    choices=["ring", "chain", "star", "grid",
                             "walker-delta", "hierarchical"],
                    help="aggregation route over the K_dp clients ('ring' "
                         "= the rotated ring; 'hierarchical' = the "
                         "two-stage pod nested plan, needs --mesh PxDxM)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--straggle-p", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="put every rank on this device (cpu, cuda:0, …); "
                         "default: one card per rank")
    args = ap.parse_args(argv)

    mesh = _mesh(args.mesh, args.device)
    home = mesh.devices[0]
    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(
        agg=AggConfig(kind=AggKind(args.agg), q=1),
        opt=OptConfig(name=args.opt, lr=args.lr),
        q_frac=args.q_frac,
        agg_dtype="float32" if args.smoke else "bfloat16",
        ef_dtype="float32" if args.smoke else "bfloat16",
    )
    agg_plan = make_agg_plan(mesh, _topology(args.topology, dp_size(mesh)))

    state = init_state(cfg, tc, mesh,
                       torch.Generator(device=home).manual_seed(args.seed),
                       topology=agg_plan)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state = ckpt.restore(args.ckpt_dir, abstract_like(state), mesh=mesh,
                             specs=state_shardings(cfg, tc, mesh,
                                                   topology=agg_plan))
        print(f"resumed from step {int(state.step)}")
    step_fn = build_train_step(cfg, tc, mesh, topology=agg_plan)

    lm = make_bigram_lm(7, cfg.vocab_size, device=home)
    sm = StragglerModel(p_straggle=args.straggle_p)
    k_dp = dp_size(mesh)
    gen = torch.Generator(device=home).manual_seed(args.seed + 1)
    gen_host = torch.Generator().manual_seed(args.seed + 2)
    t0 = time.time()
    for i in range(args.steps):
        batch = lm_batch(lm, gen, args.batch, args.seq)
        if cfg.frontend == "vision":
            fe, m = vision_stub_embeds(cfg, gen, args.batch, args.seq, 8,
                                       device=home)
            batch |= {"frontend_embeds": fe, "frontend_mask": m}
        elif cfg.frontend == "audio":
            batch |= {"frontend_embeds": audio_stub_embeds(
                cfg, gen, args.batch, args.seq, device=home)}
        if args.straggle_p > 0:
            batch["participate"] = sm.sample(gen_host, k_dp)
        state, metrics = step_fn(state, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {int(state.step):4d} "
                  f"loss {float(metrics['loss']):.4f} "
                  f"agg_bits {float(metrics['agg_bits']):.3e} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, int(state.step), state)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, int(state.step), state)
        print(f"checkpointed step {int(state.step)} → {args.ckpt_dir}")


if __name__ == "__main__":
    main()
