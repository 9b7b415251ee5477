"""Hand-written CUDA kernels of the node-step hot path and their plain
PyTorch versions (:mod:`.ref`), dispatched by :mod:`.ops`."""
