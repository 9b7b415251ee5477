"""CUDA kernels of the scalar ``[d]`` IA combine steps, bound with ctypes.

``csrc/chain_accum.cu`` replaces the Pallas TPU kernels of
:mod:`repro.kernels.chain_accum`:

* :func:`chain_accum_cuda` ← ``chain_accum_pallas`` — γ_out = γ_in + ḡ with
  its support count (the IA line of Algorithms 1/2/4);
* :func:`cl_fuse_cuda` ← ``cl_fuse_pallas`` — the whole CL-SIA node step of
  one row given τ (Algorithm 3, lines 2–5).

Their plain versions are :func:`repro_torch.kernels.ref.ref_chain_accum`
and :func:`repro_torch.kernels.ref.ref_cl_fuse`. The library is built and
loaded by :mod:`repro_torch.kernels.level`, which also holds the argument
checks; each wrapper counts its launches in ``launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import level


@level.counted
def chain_accum_cuda(gamma_in, gbar):
    """CUDA :func:`repro_torch.kernels.ref.ref_chain_accum`.

    gamma_in, gbar: [d] float32 or bfloat16, one dtype.
    → (γ_out [d] in γ_in's dtype, nnz 0-d int32).
    """
    d, dev, code = level._row_of(gamma_in)
    lib = level._load()
    dt = gamma_in.dtype
    gin = level._rows("gamma_in", gamma_in, (d,), dev, dt)
    gb = level._rows("gbar", gbar, (d,), dev, dt)
    gout = torch.empty((d,), dtype=dt, device=dev)
    nnz = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.chain_accum_launch(gin.data_ptr(), gb.data_ptr(), code,
                                    gout.data_ptr(), nnz.data_ptr(), d,
                                    level._stream(dev))
    level._raise_on(rc, "chain_accum")
    chain_accum_cuda.launches += 1
    return gout, nnz


@level.counted
def cl_fuse_cuda(g, e, gamma_in, weight, tau):
    """CUDA :func:`repro_torch.kernels.ref.ref_cl_fuse`.

    g, e, gamma_in: [d] float32 or bfloat16, one dtype; weight, tau: a
    number or a one-element float32 tensor on the rows' device (read there).
    → (γ_out, e′ [d] in the rows' dtype, nnz 0-d int32).
    """
    d, dev, code = level._row_of(g)
    lib = level._load()
    dt = g.dtype
    rows = [level._rows(name, t, (d,), dev, dt) for name, t in
            (("g", g), ("e", e), ("gamma_in", gamma_in))]
    w = level._scalar("weight", weight, dev)
    t = level._scalar("tau", tau, dev)
    gout = torch.empty((d,), dtype=dt, device=dev)
    enew = torch.empty((d,), dtype=dt, device=dev)
    nnz = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cl_fuse_launch(*(r.data_ptr() for r in rows), *w, *t, code,
                                gout.data_ptr(), enew.data_ptr(),
                                nnz.data_ptr(), d, level._stream(dev))
    level._raise_on(rc, "cl_fuse")
    cl_fuse_cuda.launches += 1
    return gout, enew, nnz
