"""Hand-written CUDA kernels of the node-step hot path and their plain
PyTorch versions (:mod:`.ref`), dispatched by :mod:`.ops`.

Importing the package imports every wrapper module, so that
:func:`.level.reset_launch_counts` covers every launch count; nothing is
built or loaded until a kernel is first called.
"""

from repro_torch.kernels import chain_accum, level, sparsify_ef  # noqa: F401
from repro_torch.kernels import topq_threshold  # noqa: F401
