"""Shared helpers for the paper-figure scripts of the PyTorch/CUDA port
(the twin of ``benchmarks/common.py``; imports only ``repro_torch``, torch
and numpy).

Every script runs on ``cuda`` unless ``--device cpu`` is given, prints its
device first (on the card: the name and power limit ``nvidia-smi``
reports) and then the rows its JAX twin prints.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import PAPER  # noqa: E402
from repro_torch.core.algorithms import AggConfig, AggKind  # noqa: E402
from repro_torch.data import (make_synthetic_mnist,  # noqa: E402
                              partition_iid)
from repro_torch.device import resolve_device  # noqa: E402

ALGS = {
    "SIA": AggKind.SIA,
    "RE-SIA": AggKind.RE_SIA,
    "CL-SIA": AggKind.CL_SIA,
    "TC-SIA": AggKind.TC_SIA,
    "CL-TC-SIA": AggKind.CL_TC_SIA,
}


def agg_config(kind: AggKind, q: int | None = None) -> AggConfig:
    q = PAPER.q if q is None else q
    ql = max(1, round(0.1 * q))
    return AggConfig(kind=kind, q=q, q_global=q - ql, q_local=ql,
                     omega=PAPER.omega)


def paper_data(num_clients: int, per_client: int = 200, seed: int = 0, *,
               device=None):
    """Synthetic MNIST split IID over ``num_clients``, and a test set."""
    train = make_synthetic_mnist(seed, num_clients * per_client,
                                 device=device)
    test = make_synthetic_mnist(seed + 1, 2000, device=device)
    fed = partition_iid(train, num_clients,
                        torch.Generator().manual_seed(seed + 2))
    return fed, test


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    return p


def device_line(device) -> str:
    """``# device: …`` — on the card, its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"# device: {dev.type}"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out = f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return f"# device: {out}"
