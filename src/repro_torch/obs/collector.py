"""Specialization counting (port of :class:`repro.obs.collector.TraceCounter`).

The reference counts jit traces: its counter is bumped inside a jitted body,
which runs once per new input shape. The port compiles nothing, so a call
site reports the signature of its inputs instead — the shapes and dtypes of
every array it is given, which is what a jit cache keys on — and the counter
counts the first call at each signature. A shape that leaks into the
signature (a plan not padded to its bucket, a cohort count not padded to a
power of two) shows as a count above the expected one, as a retrace does in
the reference.
"""

from __future__ import annotations

from typing import Any, Hashable

import numpy as np
import torch


def input_signature(*xs: Any) -> tuple:
    """The shapes and dtypes of ``xs``: tensors and arrays give
    ``(shape, dtype)``, ``None`` stays ``None``, anything else (a static
    argument) stands as itself."""
    sig = []
    for x in xs:
        if isinstance(x, (torch.Tensor, np.ndarray)):
            sig.append((tuple(x.shape), str(x.dtype)))
        else:
            sig.append(x)
    return tuple(sig)


class TraceCounter:
    """Counts specializations: ``bump()`` once per new one, or
    ``observe(signature)`` for every call, which bumps at the first call
    of each signature."""

    def __init__(self):
        self.count = 0
        self._seen: set = set()

    def bump(self) -> int:
        self.count += 1
        return self.count

    def observe(self, signature: Hashable) -> int:
        if signature not in self._seen:
            self._seen.add(signature)
            self.bump()
        return self.count
