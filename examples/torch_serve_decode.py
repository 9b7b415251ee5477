"""Serve a small model with batched requests on the PyTorch/CUDA port
(twin of ``serve_decode.py``): prefill + greedy decode loop, reporting
tokens/s and the size of the KV-cache working set.

    python examples/torch_serve_decode.py [--device cpu] [--arch mixtral-8x7b]
"""

import argparse
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    dev = resolve_device(args.device)
    max_len = args.prompt_len + args.gen
    params = model_mod.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    cache_bytes = sum(a.nbytes for a in tree_leaves(
        model_mod.cache_specs(cfg, args.batch, max_len)))
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    out = generate(cfg, params, prompts, args.gen, dev)
    step_s = statistics.median(out.seconds[1:])
    tokens = out.tokens.cpu()
    print(f"{cfg.name}: batch={args.batch}, device {dev}, KV cache "
          f"{cache_bytes/1e6:.1f} MB"
          + (f" (SWA ring buffer, window={cfg.sliding_window})"
             if cfg.sliding_window else ""))
    print(f"decode: {args.batch/step_s:.1f} tok/s "
          f"({step_s*1000:.1f} ms/step, median)")
    print("first request's tokens:", tokens[0, :12].tolist(), "...")
    return {"tokens": tokens, "cache_bytes": cache_bytes,
            "step_ms": step_s * 1e3}


if __name__ == "__main__":
    main()
