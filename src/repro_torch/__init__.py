"""PyTorch/CUDA port of :mod:`repro` — sparse incremental aggregation in
multi-hop federated learning, running on an NVIDIA H100.

The sub-packages mirror :mod:`repro`'s layout and module names. The
aggregation math is plain functions on tensors; the node-step hot path
dispatches to hand-written CUDA kernels (:mod:`repro_torch.kernels`) for
CUDA tensors and to their plain PyTorch versions for CPU tensors.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
