"""Serving CLI: batched prefill + greedy decode loop with a reduced config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

:func:`generate` is the loop itself (the CLI, the example and the chip
smoke run drive it): one prefill of the prompts, then ``gen - 1`` decode
steps, each feeding back the argmax token, under ``torch.inference_mode``.
Given a mesh of several ranks it runs split over them
(:mod:`repro_torch.models.serve_split`). The CLI serves on an ``(n, 1)``
mesh of the visible cards, as the reference's does over its devices: the
requests over ``data`` where they divide, else the cache's sequence
(split-K); one card (or ``--device cpu``) is the whole form.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as model_mod
from repro_torch.models import serve_split
from repro_torch.train.state import RankShards


@dataclasses.dataclass
class Generation:
    """What :func:`generate` returns. ``tokens`` [B, gen] (int64, on the
    device); ``logits``: the prefill's last logits then each decode step's
    ([B, V] each), kept when asked; ``seconds``: host-clock seconds of the
    prefill then of each decode step, each ended by a synchronize."""

    tokens: torch.Tensor
    logits: Optional[List[torch.Tensor]]
    seconds: List[float]


def generate(cfg: ModelConfig, params, prompts: torch.Tensor, gen: int,
             device: DeviceLike = None, *, keep_logits: bool = False,
             mesh=None) -> Generation:
    """Greedy generation of ``gen`` tokens after ``prompts`` [B, S].

    Runs on ``device`` (the card unless asked for another; raises where
    there is none), with a fresh cache of S + gen positions. The decode
    position is a host int, so no step reads the device; each step ends in
    a synchronize, as a server streaming its tokens would. With a ``mesh``
    of several ranks the step runs split over them (``device`` is then the
    mesh's first device): ``params`` whole (placed here) or placed by
    :func:`~repro_torch.models.serve_split.place_params`, the cache placed
    by ``cache_pspecs``.
    """
    split = None
    if serve_split.is_split(mesh):
        dev = mesh.devices[0]
        split = serve_split.ServeSplit(cfg, mesh, prompts.shape[0],
                                       prompts.shape[1] + gen)
        if not isinstance(params, RankShards):
            params = serve_split.place_params(params, cfg, mesh)
    else:
        dev = resolve_device(device)
    b, s = prompts.shape
    prompts = prompts.to(dev)
    devs = mesh.distinct() if split is not None else (dev,)
    cards = [d for d in devs if d.type == "cuda"]

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    out, seconds, kept = [], [], []
    with torch.inference_mode():
        cache = (split.init_cache() if split is not None else
                 model_mod.init_cache(cfg, b, s + gen, dev))
        sync()
        for i in range(gen):
            t0 = time.perf_counter()
            if split is not None and i == 0:
                logits, cache = split.prefill(params, cache, prompts)
            elif split is not None:
                logits, cache = split.decode(params, cache, out[-1],
                                             s + i - 1)
            elif i == 0:
                logits, cache = model_mod.prefill(cfg, params, prompts, cache)
            else:
                logits, cache = model_mod.decode_step(cfg, params, cache,
                                                      out[-1], s + i - 1)
            out.append(torch.argmax(logits, -1))
            sync()
            seconds.append(time.perf_counter() - t0)
            if keep_logits:
                kept.append(logits)
        tokens = torch.stack(out, dim=1)
    return Generation(tokens=tokens, logits=kept if keep_logits else None,
                      seconds=seconds)


def main(argv=None) -> Generation:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    # an (n, 1) mesh of the visible cards, as the reference's CLI
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    mesh = make_mesh((n, 1), ("data", "model"),
                     [torch.device("cuda", i) for i in range(n)]
                     if n > 1 else [dev])
    params = model_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    t0 = time.time()
    out = generate(cfg, params, prompts, args.gen, dev, mesh=mesh)
    gen = out.tokens.cpu()
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} generated={gen.shape[1]} tokens "
          f"in {dt:.2f}s ({args.batch*gen.shape[1]/dt:.1f} tok/s)")
    print("sample generations (token ids):")
    for row in gen[:2].tolist():
        print("  ", row)
    return out


if __name__ == "__main__":
    main()
