"""CUDA kernel of the scalar ``[d]`` fused error feedback + sparsify, bound
with ctypes.

``csrc/sparsify_ef.cu`` replaces the Pallas TPU kernel of
:mod:`repro.kernels.sparsify_ef`: :func:`sparsify_ef_cuda` ←
``sparsify_ef_pallas`` — g̃ = w·g + e, keep = |g̃| ≥ τ ∨ mask_in, ḡ, e′ and
nnz in one pass (the node step of Algorithms 1/2/4).

Its plain version is :func:`repro_torch.kernels.ref.ref_sparsify_ef`. The
library is built and loaded by :mod:`repro_torch.kernels.level`, which
also holds the argument checks; the wrapper counts its launches in
``launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import level


@level.counted
def sparsify_ef_cuda(g, e, mask_in, weight, tau):
    """CUDA :func:`repro_torch.kernels.ref.ref_sparsify_ef`.

    g, e: [d] float32 or bfloat16, one dtype; mask_in: [d] float32 (only
    ``> 0`` is read) or None; weight, tau: a number or a one-element
    float32 tensor on the rows' device (read there).
    → (ḡ, e′ [d] in the rows' dtype, nnz 0-d int32).
    """
    d, dev, code = level._row_of(g)
    lib = level._load()
    dt = g.dtype
    gr = level._rows("g", g, (d,), dev, dt)
    er = level._rows("e", e, (d,), dev, dt)
    mask = None if mask_in is None else level._rows(
        "mask_in", mask_in, (d,), dev)
    w = level._scalar("weight", weight, dev)
    t = level._scalar("tau", tau, dev)
    gbar = torch.empty((d,), dtype=dt, device=dev)
    enew = torch.empty((d,), dtype=dt, device=dev)
    nnz = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sparsify_ef_launch(gr.data_ptr(), er.data_ptr(),
                                    level._ptr(mask), *w, *t, code,
                                    gbar.data_ptr(), enew.data_ptr(),
                                    nnz.data_ptr(), d, level._stream(dev))
    level._raise_on(rc, "sparsify_ef")
    sparsify_ef_cuda.launches += 1
    return gbar, enew, nnz
