from repro_torch.runtime import elastic, fault

__all__ = ["elastic", "fault"]
