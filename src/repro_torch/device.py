"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device;
with no card they raise instead of quietly taking the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev



def to_device(x: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """``x`` on ``dst``. Asynchronous only between two cards: a copy from a
    card to the CPU returns before it lands (pinned staging), and the CPU
    code reads the result at once."""
    if x.device == torch.device(dst):
        return x
    return x.to(dst, non_blocking=x.device.type == "cuda"
                and dst.type == "cuda")
