"""Federated data partitioning and per-round minibatches (port of
:mod:`repro.data.federated`: the IID split and client minibatches).

Randomness comes from explicit ``torch.Generator``s on the CPU, so a seed
draws the same partition and minibatches whatever device holds the data.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.data.synthetic import Dataset

Tensor = torch.Tensor


class FederatedData(NamedTuple):
    x: Tensor          # [K, n_k, 784]
    y: Tensor          # [K, n_k]

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def samples_per_client(self) -> int:
        return self.x.shape[1]


def partition_iid(data: Dataset, num_clients: int,
                  generator: torch.Generator) -> FederatedData:
    """Shuffle and split into ``num_clients`` equal shards (n // K each)."""
    n = data.x.shape[0]
    n_k = n // num_clients
    perm = torch.randperm(n, generator=generator)[: n_k * num_clients]
    perm = perm.to(data.x.device)
    return FederatedData(x=data.x[perm].reshape(num_clients, n_k, -1),
                         y=data.y[perm].reshape(num_clients, n_k))


def minibatch_indices(fed: FederatedData, batch_size: int,
                      generator: torch.Generator) -> Tensor:
    """Per-client sample indices of one round, int64 [K, batch_size]
    (drawn with replacement, on the CPU)."""
    return torch.randint(0, fed.samples_per_client,
                         (fed.num_clients, batch_size), generator=generator)


def client_minibatch(fed: FederatedData, batch_size: int,
                     generator: Optional[torch.Generator] = None, *,
                     idx: Optional[Tensor] = None):
    """One minibatch per client → (x [K, b, 784], y [K, b]).

    ``idx`` ([K, b]) replays given draws; otherwise they are drawn from
    ``generator``.
    """
    if idx is None:
        idx = minibatch_indices(fed, batch_size, generator)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=fed.x.device)
    rows = torch.arange(fed.num_clients, device=fed.x.device)[:, None]
    return fed.x[rows, idx], fed.y[rows, idx]
