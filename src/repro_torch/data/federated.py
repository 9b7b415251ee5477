"""Federated data partitioning and per-round minibatches (port of
:mod:`repro.data.federated`: the IID and Dirichlet non-IID splits and
client minibatches).

Randomness comes from explicit ``torch.Generator``s on the CPU, or from
numpy's ``default_rng(seed)`` for the Dirichlet split, so a seed draws the
same partition and minibatches whatever device holds the data.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
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


def partition_dirichlet(data: Dataset, num_clients: int, seed: int,
                        alpha: float = 0.5,
                        num_classes: int = 10) -> FederatedData:
    """Label-skewed split: class proportions per client ~ Dir(alpha).

    Equal client sizes (n // K); within each client, sample indices are
    drawn (with replacement where a class runs short) by the client's class
    mixture. ``seed`` seeds numpy's ``default_rng``, and the same numpy
    calls run in the same order as the reference's, so the integer that
    the reference draws from its key gives its split bit for bit.
    """
    n = int(data.x.shape[0])
    n_k = n // num_clients
    rng = np.random.default_rng(int(seed))
    x = data.x.detach().cpu().numpy()
    y = data.y.detach().cpu().numpy()
    by_class = [np.where(y == c)[0] for c in range(num_classes)]
    props = rng.dirichlet([alpha] * num_classes, size=num_clients)
    xs, ys = [], []
    for k in range(num_clients):
        counts = rng.multinomial(n_k, props[k])
        idx = []
        for c, cnt in enumerate(counts):
            if cnt == 0:
                continue
            pool = by_class[c]
            take = rng.choice(pool, size=cnt, replace=cnt > len(pool))
            idx.append(take)
        idx = np.concatenate(idx) if idx else np.zeros((0,), np.int64)
        if len(idx) < n_k:   # degenerate dirichlet draw — pad uniformly
            extra = rng.integers(0, n, n_k - len(idx))
            idx = np.concatenate([idx, extra])
        rng.shuffle(idx)
        xs.append(x[idx])
        ys.append(y[idx])
    dev = data.x.device
    return FederatedData(x=torch.from_numpy(np.stack(xs)).to(dev),
                         y=torch.from_numpy(np.stack(ys)).to(dev))


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
