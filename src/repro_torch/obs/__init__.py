"""Round telemetry (port of :mod:`repro.obs`): so far the specialization
counter that audits the batched round path."""

from repro_torch.obs.collector import TraceCounter, input_signature

__all__ = ["TraceCounter", "input_signature"]
