"""CUDA kernels of the scalar ``[d]`` candidate counts of threshold Top-Q,
bound with ctypes.

``csrc/topq_threshold.cu`` replaces the Pallas TPU kernels of
:mod:`repro.kernels.topq_threshold`:

* :func:`count_ge_cuda` ← ``count_ge_pallas`` — counts[j] = #{i : |x_i| ≥
  τ_j}, what ``threshold_for_topq(x, q, count_fn=ops.count_ge)`` counts
  with on a 1-D ``x``;
* :func:`count_ge_fused_cuda` ← ``count_ge_fused_pallas`` — the same counts
  of the operand ``w·g + e`` (``p·(w·g + e) + γ_in`` with
  ``include_gamma``) rebuilt per element from the raw node inputs.

Taus may come in any order (up to :data:`MAX_TAUS` of them). Nothing is
padded, so a τ ≤ 0 counts only the d real elements and no pad count is
subtracted. Their plain versions are
:func:`repro_torch.kernels.ref.ref_count_ge` and
:func:`repro_torch.kernels.ref.ref_count_ge_fused`. The library is built
and loaded by :mod:`repro_torch.kernels.level`; each wrapper counts its
launches in ``launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import level

Tensor = torch.Tensor

#: Largest number of taus a count takes: the sorted taus and the rank
#: histogram share 48 KB of shared memory per block (as ``level.MAX_TAUS``).
MAX_TAUS = level.MAX_TAUS


def _taus(taus, dev: torch.device) -> Tensor:
    if not isinstance(taus, Tensor) or taus.dim() != 1:
        raise ValueError("taus must be a [B] tensor")
    n = taus.shape[0]
    if not 1 <= n <= MAX_TAUS:
        raise ValueError(f"taus holds {n} values; the count kernels take "
                         f"1..{MAX_TAUS} (MAX_TAUS)")
    return level._check("taus", taus, (n,), dev)


def _count(launch, name: str, row_args: list, taus, dev, d: int):
    n = taus.shape[0]
    scratch = torch.empty((level._load().count_scratch_words(n),),
                          dtype=torch.int32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = launch(*row_args, taus.data_ptr(), n, scratch.data_ptr(),
                    counts.data_ptr(), d, level._stream(dev))
    level._raise_on(rc, name)
    return counts


@level.counted
def count_ge_cuda(x, taus):
    """CUDA :func:`repro_torch.kernels.ref.ref_count_ge`.

    x: [d] float32 or bfloat16; taus: [B] float32 in any order, B ≤
    MAX_TAUS. → counts [B] int32.
    """
    d, dev, code = level._row_of(x)
    lib = level._load()
    xr = level._rows("x", x, (d,), dev, x.dtype)
    counts = _count(lib.count_ge_launch, "count_ge", [xr.data_ptr(), code],
                    _taus(taus, dev), dev, d)
    count_ge_cuda.launches += 1
    return counts


@level.counted
def count_ge_fused_cuda(g, e, gamma_in, weight, participate, taus, *,
                        include_gamma: bool = False):
    """CUDA :func:`repro_torch.kernels.ref.ref_count_ge_fused`.

    g, e, gamma_in (read only with ``include_gamma``): [d] float32 or
    bfloat16, one dtype; weight, participate: a number or a one-element
    float32 tensor on the rows' device; taus: [B] float32 in any order.
    → counts [B] int32 of ``|w·g + e|`` (``|p·(w·g + e) + γ_in|``).
    """
    d, dev, code = level._row_of(g)
    lib = level._load()
    dt = g.dtype
    rows = [level._rows(name, t, (d,), dev, dt) for name, t in
            (("g", g), ("e", e))]
    rows.append(level._rows("gamma_in", gamma_in, (d,), dev, dt)
                if include_gamma else None)
    w = level._scalar("weight", weight, dev)
    p = level._scalar("participate", participate, dev)
    counts = _count(lib.count_ge_fused_launch, "count_ge_fused",
                    [*map(level._ptr, rows), *w, *p, code],
                    _taus(taus, dev), dev, d)
    count_ge_fused_cuda.launches += 1
    return counts
