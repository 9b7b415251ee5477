"""Train a transformer LM with CL-SIA gradient aggregation (the paper's
best algorithm) as the data-parallel collective, on the PyTorch/CUDA port
(twin of ``train_lm_sia.py``).

Default is a ~3M-param model for a few hundred steps; ``--params 100m``
takes the full-size run (same code path). ``--mesh 4x1`` (the default)
puts four clients on ``--device``.

    python examples/torch_train_lm_sia.py --steps 200 [--device cpu]
    python examples/torch_train_lm_sia.py --params 100m --steps 300
"""

import argparse
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.algorithms import AggConfig, AggKind  # noqa: E402
from repro_torch.data.synthetic import lm_batch, make_bigram_lm  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim.optimizers import OptConfig  # noqa: E402
from repro_torch.train.state import TrainConfig  # noqa: E402
from repro_torch.train.step import build_train_step, init_state  # noqa: E402

CONFIGS = {
    "3m": ModelConfig(name="lm-3m", family="dense", num_layers=4,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=512, head_dim=32, param_dtype="float32"),
    "100m": ModelConfig(name="lm-100m", family="dense", num_layers=12,
                        d_model=768, num_heads=12, num_kv_heads=4,
                        d_ff=3072, vocab_size=32000, head_dim=64,
                        param_dtype="float32"),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", choices=list(CONFIGS), default="3m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--q-frac", type=float, default=0.01)
    ap.add_argument("--mesh", default="4x1", help="DxM clients × columns")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = CONFIGS[args.params]
    dev = resolve_device(args.device)
    shape = tuple(int(x) for x in args.mesh.split("x"))
    mesh = make_mesh(shape, ("data", "model"), [dev] * math.prod(shape))
    tc = TrainConfig(agg=AggConfig(kind=AggKind.CL_SIA, q=1),
                     opt=OptConfig(name="adamw", lr=1e-3, grad_clip=1.0),
                     q_frac=args.q_frac, agg_dtype="float32",
                     ef_dtype="float32", lr_warmup=20)

    state = init_state(cfg, tc, mesh,
                       torch.Generator(device=dev).manual_seed(0))
    step = build_train_step(cfg, tc, mesh)
    lm = make_bigram_lm(7, cfg.vocab_size, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        state, m = step(state, lm_batch(lm, gen, args.batch, args.seq))
        losses.append(float(m["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"uplink {float(m['agg_bits'])/8e6:.2f} MB "
                  f"({time.time()-t0:.0f}s)")
    # a bigram LM's optimal CE is well below the unigram entropy — verify
    # we actually learned structure
    print(f"final loss {losses[-1]:.4f} "
          f"(uniform would be {math.log(cfg.vocab_size):.2f})")
    return {"losses": losses}


if __name__ == "__main__":
    main()
