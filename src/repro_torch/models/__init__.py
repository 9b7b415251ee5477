"""Model substrate: decoder stacks for all assigned architecture families."""

from repro_torch.models import model, transformer

__all__ = ["model", "transformer"]
