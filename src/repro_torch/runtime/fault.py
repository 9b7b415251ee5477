"""Straggler mitigation and failure handling (port of
:mod:`repro.runtime.fault`).

The mechanism is the paper's own error feedback: a client that misses the
round's deadline gets ``participate=0`` — its node step forwards γ
unchanged and banks the *entire* effective gradient in EF, which is then
transmitted (sparsified) in later rounds.

Failure handling is topological: a dead *relay* is bypassed by re-ordering
the chain or re-routing the tree around it. The dead client's banked mass
is lost if it never returns, bounded by ‖e_dead‖, which the simulator logs
every round (:func:`dead_banked_mass`, ``RoundLog.ef_dead_mass``).

The reference draws straggler masks with ``jax.random``; the port draws
from a ``torch.Generator`` the caller passes in, so the process is the
same and the realized masks are not. A test that needs the reference's
masks feeds them in as arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StragglerModel:
    """Random straggler process for simulation/testing."""

    p_straggle: float = 0.0          # per-client per-round straggle prob
    correlated: bool = False         # slow client stays slow next round
    p_recover: float = 0.5

    def sample(self, generator: torch.Generator, k: int,
               prev: Optional[Tensor] = None) -> Tensor:
        """→ participation mask [K] of {0., 1.} (float32, on the CPU).

        ``prev`` is the last round's mask: with ``correlated``, a client
        slow then stays slow unless it recovers (probability
        ``p_recover``).
        """
        if self.p_straggle <= 0:
            return torch.ones((k,), dtype=torch.float32)
        fresh = torch.rand((k,), generator=generator) >= self.p_straggle
        if self.correlated and prev is not None:
            recover = torch.rand((k,), generator=generator) < self.p_recover
            stay_slow = (torch.as_tensor(prev).cpu() == 0) & ~recover
            fresh = fresh & ~stay_slow
        return fresh.to(torch.float32)


def deadline_mask(arrival_times: Tensor, deadline: float) -> Tensor:
    """Deadline-based participation from (simulated) per-client latencies."""
    return (torch.as_tensor(arrival_times) <= deadline).to(torch.float32)


def heal_chain(order: np.ndarray, dead) -> np.ndarray:
    """Remove dead relay(s) from a chain order (numpy, host-side decision).

    ``dead`` is a single node or any iterable of simultaneously dead nodes.
    Relative order of the survivors is preserved — the chain splices around
    the gap(s).
    """
    dead_set = {int(dead)} if np.isscalar(dead) else {int(d) for d in dead}
    return np.asarray([o for o in order if int(o) not in dead_set],
                      dtype=np.int32)


def banked_mass(ef: Tensor) -> Tensor:
    """Per-client ‖e_k‖₁ — the loss bound if client k dies now."""
    return ef.abs().sum(dim=-1)


def dead_banked_mass(ef: Tensor, participation: Tensor) -> Tensor:
    """‖e_dead‖ — total banked EF mass held by non-participants.

    ``participation`` is the effective [K] mask (participate ∧ alive). A
    client at 0 still *holds* its bank — the mass is only lost if it never
    returns — so this is the round's exposure bound. Leading axes (cohorts:
    ``ef`` [B, K, d], ``participation`` [B, K]) give one value each.
    """
    dead = 1.0 - torch.clamp(participation, 0.0, 1.0)
    return (dead * banked_mass(ef)).sum(dim=-1)
