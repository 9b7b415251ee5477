from repro_torch.runtime import fault

__all__ = ["fault"]
