"""CUDA kernels for one level of W concurrent node steps, bound with ctypes.

The kernels live in ``csrc/`` and replace the Pallas TPU kernels of
:mod:`repro.kernels.level`. ``csrc/level.cu``:

* :func:`cl_fuse_level_cuda` ← ``cl_fuse_level_pallas`` — the whole CL
  node step (Algorithms 3/5, stragglers included);
* :func:`sparsify_ef_level_cuda` ← ``sparsify_ef_level_pallas`` — fused
  error feedback + sparsify (Algorithms 1/2/4);
* :func:`chain_accum_level_cuda` ← ``chain_accum_level_pallas`` — the IA
  combine with its support counts.

``csrc/tau_search.cu`` (the threshold Top-Q τ search):

* :func:`count_ge_fused_level_cuda` ← ``count_ge_fused_level_pallas`` —
  candidate counts of the operand rebuilt from the raw node inputs;
* :func:`count_ge_level_cuda` ← ``count_ge_level_pallas`` — candidate
  counts over a materialized ``[W, d]`` operand;
* :func:`hist_topq_level_cuda` ← ``hist_topq_level_pallas`` — the joint
  digit histogram of ``tau_impl="hist"``.

Each is bounded by device-memory bytes at large d (see the sources'
headers). Their plain PyTorch versions are in
:mod:`repro_torch.kernels.ref`; the dispatching entries in
:mod:`repro_torch.kernels.ops` pick one or the other by the device of the
tensors they are given.

The scalar ``[d]`` kernels (``csrc/chain_accum.cu``, ``csrc/sparsify_ef.cu``,
``csrc/topq_threshold.cu``) have their wrappers in :mod:`.chain_accum`,
:mod:`.sparsify_ef` and :mod:`.topq_threshold`; this module builds and
binds them with the rest and holds the argument checks they share.

The sources are compiled with ``nvcc`` into ``build/`` at the repository
root at first use (one object per source, compiled in parallel, linked
into a content-addressed shared library with a plain C interface), then
loaded with :mod:`ctypes`. Nothing is compiled or loaded at import. Each
wrapper counts its launches in its ``launches`` attribute;
:func:`reset_launch_counts` sets every count to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import numbers
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "level.cu", CSRC / "tau_search.cu", CSRC / "chain_accum.cu",
           CSRC / "sparsify_ef.cu", CSRC / "topq_threshold.cu")
HEADERS = (CSRC / "tile.cuh", CSRC / "rank.cuh", CSRC / "row.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_GM_NONE, _GM_SHARED, _GM_LANE = 0, 1, 2

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the level kernels cannot be built")
    return found


def library_path() -> Path:
    """The shared library's path, named by the sources' content hash."""
    digest = hashlib.sha1(" ".join(ARCH_FLAGS).encode())
    for path in SOURCES + HEADERS:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"liblevel-{digest.hexdigest()[:12]}.so"


def build() -> str:
    """Compile ``csrc/*.cu`` if the library is missing; → nvcc's log.

    One ``nvcc -c`` per source, all started together, then one link.
    ``-Xptxas -v`` is always on, so the log lists each kernel's registers
    and shared memory. The library is written under a temporary name and
    renamed, so concurrent processes never load a half-written file.
    """
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, p.returncode, log) for src, p, log
                  in zip(SOURCES, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        lib = os.path.join(tmpdir, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib,
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return "".join(logs)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tail = [i, ll, p]                      # w_lanes, d, stream
        lib.cl_fuse_level_launch.argtypes = [p] * 8 + [i] + [p] * 7 + tail
        lib.sparsify_ef_level_launch.argtypes = [p] * 11 + tail
        lib.chain_accum_level_launch.argtypes = [p] * 4 + [i] + [p] * 3 + tail
        lib.level_tiles.argtypes = [ll]
        lib.count_ge_level_launch.argtypes = [p, i] + [p] * 3 + [i, i, ll, p]
        lib.count_ge_fused_level_launch.argtypes = (
            [p] * 6 + [i] + [p] * 3 + [i, i, ll, p])
        lib.hist_topq_level_launch.argtypes = (
            [p] * 6 + [i] + [p] * 6 + [i, i, ll, p])
        lib.hist_shared_max_branch.argtypes = []
        f = ctypes.c_float
        scalars = [p, f, p, f]                 # (pointer or null, value) × 2
        lib.chain_accum_launch.argtypes = [p, p, i, p, p, ll, p]
        lib.cl_fuse_launch.argtypes = [p] * 3 + scalars + [i, p, p, p, ll, p]
        lib.sparsify_ef_launch.argtypes = ([p] * 3 + scalars
                                           + [i, p, p, p, ll, p])
        lib.count_scratch_words.argtypes = [i]
        lib.count_ge_launch.argtypes = [p, i, p, i, p, p, ll, p]
        lib.count_ge_fused_launch.argtypes = ([p] * 3 + scalars
                                              + [i, p, i, p, p, ll, p])
        for fn in (lib.cl_fuse_level_launch, lib.sparsify_ef_level_launch,
                   lib.chain_accum_level_launch, lib.level_tiles,
                   lib.count_ge_level_launch,
                   lib.count_ge_fused_level_launch,
                   lib.hist_topq_level_launch, lib.hist_shared_max_branch,
                   lib.chain_accum_launch, lib.cl_fuse_launch,
                   lib.sparsify_ef_launch, lib.count_scratch_words,
                   lib.count_ge_launch, lib.count_ge_fused_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _check(name: str, t: Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.float32) -> Tensor:
    if not isinstance(t, Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


def _rows(name: str, t: Tensor, shape: tuple, device: torch.device,
          dtype: torch.dtype = torch.float32):
    """A [W, d] (or [d]) operand, read with 16-byte loads: one that does
    not start on a 16-byte boundary (a row view inside a larger batch) is
    copied."""
    t = _check(name, t, shape, device, dtype)
    return t.clone() if t.data_ptr() % 16 else t


def _lanes(g: Tensor) -> tuple:
    if g.dim() != 2 or g.device.type != "cuda":
        raise ValueError("expected a [W, d] CUDA tensor, got "
                         f"{tuple(g.shape)} on {g.device}")
    w_lanes, d = g.shape
    if w_lanes < 1 or d < 1:
        raise ValueError(f"empty level {tuple(g.shape)}")
    return w_lanes, d, g.device


def _gmask(gmask: Optional[Tensor], w_lanes: int, d: int,
           dev: torch.device) -> tuple:
    """→ (tensor, kind): lane-shared [d] masks are read with scalar loads,
    per-lane [W, d] masks like the other rows."""
    if gmask is None:
        return None, _GM_NONE
    if gmask.dim() == 1:
        return _check("gmask", gmask, (d,), dev), _GM_SHARED
    return _rows("gmask", gmask, (w_lanes, d), dev), _GM_LANE


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _err_scratch(with_err: bool, lib, w_lanes: int, d: int, dev):
    if not with_err:
        return None, None
    tiles = lib.level_tiles(d)
    return (torch.empty((w_lanes, tiles), dtype=torch.float32, device=dev),
            torch.empty((w_lanes,), dtype=torch.float32, device=dev))


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def cl_fuse_level_cuda(g, e, gamma_in, weight, tau, participate, valid,
                       gmask=None, mask_in=None, *, with_err: bool = False):
    """CUDA :func:`repro_torch.kernels.ref.ref_cl_fuse_level`.

    g, e, gamma_in, mask_in: [W, d]; weight, tau, participate, valid: [W];
    gmask: None, lane-shared [d] or per-lane [W, d]; all float32.
    → (γ_out, e′, nnz, nnz_off) (+ pinned ‖e′‖² with ``with_err``).
    """
    w_lanes, d, dev = _lanes(g)
    lib = _load()
    rows, lane = (w_lanes, d), (w_lanes,)
    ins = [_rows("g", g, rows, dev), _rows("e", e, rows, dev),
           _rows("gamma_in", gamma_in, rows, dev),
           _check("weight", weight, lane, dev), _check("tau", tau, lane, dev),
           _check("participate", participate, lane, dev),
           _check("valid", valid, lane, dev)]
    gm, gm_kind = _gmask(gmask, w_lanes, d, dev)
    mask = None if mask_in is None else _rows("mask_in", mask_in, rows, dev)
    gout = torch.empty(rows, dtype=torch.float32, device=dev)
    enew = torch.empty(rows, dtype=torch.float32, device=dev)
    nnz = torch.empty(lane, dtype=torch.int32, device=dev)
    nnz_off = torch.empty(lane, dtype=torch.int32, device=dev)
    tile_err, err = _err_scratch(with_err, lib, w_lanes, d, dev)
    with torch.cuda.device(dev):
        rc = lib.cl_fuse_level_launch(
            *map(_ptr, ins), _ptr(gm), gm_kind, _ptr(mask), _ptr(gout),
            _ptr(enew), _ptr(nnz), _ptr(nnz_off), _ptr(tile_err), _ptr(err),
            w_lanes, d, _stream(dev))
    _raise_on(rc, "cl_fuse_level")
    cl_fuse_level_cuda.launches += 1
    out = (gout, enew, nnz, nnz_off)
    return out + (err,) if with_err else out


def sparsify_ef_level_cuda(g, e, mask_in, weight, tau, valid, *,
                           with_err: bool = False):
    """CUDA :func:`repro_torch.kernels.ref.ref_sparsify_ef_level`.

    g, e, mask_in (or None): [W, d]; weight, tau, valid: [W]; float32.
    → (ḡ, e′, nnz) (+ pinned ‖e′‖² with ``with_err``).
    """
    w_lanes, d, dev = _lanes(g)
    lib = _load()
    rows, lane = (w_lanes, d), (w_lanes,)
    ins = [_rows("g", g, rows, dev), _rows("e", e, rows, dev),
           None if mask_in is None else _rows("mask_in", mask_in, rows, dev),
           _check("weight", weight, lane, dev), _check("tau", tau, lane, dev),
           _check("valid", valid, lane, dev)]
    gbar = torch.empty(rows, dtype=torch.float32, device=dev)
    enew = torch.empty(rows, dtype=torch.float32, device=dev)
    nnz = torch.empty(lane, dtype=torch.int32, device=dev)
    tile_err, err = _err_scratch(with_err, lib, w_lanes, d, dev)
    with torch.cuda.device(dev):
        rc = lib.sparsify_ef_level_launch(
            *map(_ptr, ins), _ptr(gbar), _ptr(enew), _ptr(nnz),
            _ptr(tile_err), _ptr(err), w_lanes, d, _stream(dev))
    _raise_on(rc, "sparsify_ef_level")
    sparsify_ef_level_cuda.launches += 1
    out = (gbar, enew, nnz)
    return out + (err,) if with_err else out


def chain_accum_level_cuda(gamma_in, gbar, valid, gmask=None):
    """CUDA :func:`repro_torch.kernels.ref.ref_chain_accum_level`.

    gamma_in, gbar: [W, d]; valid: [W]; gmask: None, [d] or [W, d].
    → (γ_out, nnz, nnz_off).
    """
    w_lanes, d, dev = _lanes(gamma_in)
    lib = _load()
    rows, lane = (w_lanes, d), (w_lanes,)
    ins = [_rows("gamma_in", gamma_in, rows, dev),
           _rows("gbar", gbar, rows, dev), _check("valid", valid, lane, dev)]
    gm, gm_kind = _gmask(gmask, w_lanes, d, dev)
    gout = torch.empty(rows, dtype=torch.float32, device=dev)
    nnz = torch.empty(lane, dtype=torch.int32, device=dev)
    nnz_off = torch.empty(lane, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.chain_accum_level_launch(
            *map(_ptr, ins), _ptr(gm), gm_kind, _ptr(gout), _ptr(nnz),
            _ptr(nnz_off), w_lanes, d, _stream(dev))
    _raise_on(rc, "chain_accum_level")
    chain_accum_level_cuda.launches += 1
    return gout, nnz, nnz_off


# ---------------------------------------------------------------------------
# τ search: candidate counts and the joint digit histogram
# ---------------------------------------------------------------------------

#: Largest number of taus per lane the count kernels take: the sorted taus,
#: the rank histogram (and count_ge_level's rank table) share 48 KB of
#: shared memory per block.
MAX_TAUS = 4095
#: Largest branch of the joint histogram (the reference's limit too).
MAX_BRANCH = 1024


def _taus(name: str, taus: Tensor, w_lanes: int, dev, limit: int) -> Tensor:
    if not isinstance(taus, Tensor) or taus.dim() != 2:
        raise ValueError(f"{name} must be a [W, B] tensor")
    n = taus.shape[1]
    if not 1 <= n <= limit:
        raise ValueError(f"{name} holds {n} values per lane; the kernel "
                         f"takes 1..{limit}")
    return _check(name, taus, (w_lanes, n), dev)


def _fused_operand_args(g, e, gamma_in, weight, participate, gmask,
                        include_gamma: bool):
    w_lanes, d, dev = _lanes(g)
    rows, lane = (w_lanes, d), (w_lanes,)
    ins = [_rows("g", g, rows, dev), _rows("e", e, rows, dev),
           _rows("gamma_in", gamma_in, rows, dev) if include_gamma
           else None,
           _check("weight", weight, lane, dev),
           _check("participate", participate, lane, dev)]
    gm, gm_kind = _gmask(gmask, w_lanes, d, dev)
    return w_lanes, d, dev, ins + [gm], gm_kind


def count_ge_level_cuda(x, taus):
    """CUDA :func:`repro_torch.kernels.ref.ref_count_ge_level`.

    x: [W, d] float32 or bfloat16 (read as float32 in the kernel, not
    copied); taus: [W, B] float32 in any order, B ≤ MAX_TAUS.
    → counts [W, B] int32, ``#{i : |x_{w,i}| >= taus_{w,b}}``. Each rank
    comes from a table of the lane's taus (one load, a search only in a
    bucket that holds a τ), not from a binary search.
    """
    w_lanes, d, dev = _lanes(x)
    if x.dtype not in ROW_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    lib = _load()
    x = _rows("x", x, (w_lanes, d), dev, x.dtype)
    taus = _taus("taus", taus, w_lanes, dev, MAX_TAUS)
    n = taus.shape[1]
    ranks = torch.empty((w_lanes, n + 1), dtype=torch.int32, device=dev)
    counts = torch.empty((w_lanes, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.count_ge_level_launch(_ptr(x), ROW_DTYPES[x.dtype],
                                       _ptr(taus), _ptr(ranks), _ptr(counts),
                                       w_lanes, n, d, _stream(dev))
    _raise_on(rc, "count_ge_level")
    count_ge_level_cuda.launches += 1
    return counts


def count_ge_fused_level_cuda(g, e, gamma_in, weight, participate, taus,
                              gmask=None, *, include_gamma: bool = False):
    """CUDA :func:`repro_torch.kernels.ref.ref_count_ge_fused_level`.

    g, e, gamma_in (read only with ``include_gamma``): [W, d]; weight,
    participate: [W]; taus: [W, B]; gmask: None, lane-shared [d] or
    per-lane [W, d]; all float32. → counts [W, B] int32 of the operand
    ``(1−m)·(p·(w·g + e) + γ_in)`` (factors dropped per the flags).
    """
    w_lanes, d, dev, ins, gm_kind = _fused_operand_args(
        g, e, gamma_in, weight, participate, gmask, include_gamma)
    lib = _load()
    taus = _taus("taus", taus, w_lanes, dev, MAX_TAUS)
    n = taus.shape[1]
    ranks = torch.empty((w_lanes, n + 1), dtype=torch.int32, device=dev)
    counts = torch.empty((w_lanes, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.count_ge_fused_level_launch(
            *map(_ptr, ins), gm_kind, _ptr(taus), _ptr(ranks),
            _ptr(counts), w_lanes, n, d, _stream(dev))
    _raise_on(rc, "count_ge_fused_level")
    count_ge_fused_level_cuda.launches += 1
    return counts


def hist_topq_level_cuda(g, e, gamma_in, weight, participate, tables,
                         gmask=None, *, include_gamma: bool = False):
    """CUDA :func:`repro_torch.kernels.ref.ref_hist_topq_level`.

    Operand arguments as :func:`count_ge_fused_level_cuda`; ``tables =
    (tau1 [W, b], new_lo, w2, top_shift [W, b+1])`` float32, b ≤
    MAX_BRANCH. → ``(D2 [W, b+1, b+1], F [W, b+1])`` int32.
    """
    w_lanes, d, dev, ins, gm_kind = _fused_operand_args(
        g, e, gamma_in, weight, participate, gmask, include_gamma)
    lib = _load()
    tau1, new_lo, w2, top_shift = tables
    tau1 = _taus("tau1", tau1, w_lanes, dev, MAX_BRANCH)
    branch = tau1.shape[1]
    nb = branch + 1
    rest = [_check(name, t, (w_lanes, nb), dev) for name, t in
            (("new_lo", new_lo), ("w2", w2), ("top_shift", top_shift))]
    d2 = torch.empty((w_lanes, nb, nb), dtype=torch.int32, device=dev)
    f = torch.empty((w_lanes, nb), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hist_topq_level_launch(
            *map(_ptr, ins), gm_kind, _ptr(tau1), *map(_ptr, rest),
            _ptr(d2), _ptr(f), w_lanes, branch, d, _stream(dev))
    _raise_on(rc, "hist_topq_level")
    hist_topq_level_cuda.launches += 1
    return d2, f


def hist_shared_max_branch() -> int:
    """Largest branch whose histogram the kernel keeps in shared memory;
    a larger one takes the global-atomics variant."""
    return _load().hist_shared_max_branch()


# ---------------------------------------------------------------------------
# argument checks shared by the scalar [d] kernels
# ---------------------------------------------------------------------------

#: Row dtypes of the scalar kernels and their codes in the C interface.
ROW_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _row_of(x) -> tuple:
    """→ (d, device, dtype code) of the row a scalar kernel walks."""
    if not isinstance(x, Tensor):
        raise TypeError(f"expected a [d] CUDA tensor, got {type(x).__name__}")
    if x.dim() != 1 or x.device.type != "cuda":
        raise ValueError("expected a [d] CUDA tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    if x.dtype not in ROW_DTYPES:
        raise TypeError(f"rows must be float32 or bfloat16, got {x.dtype}")
    return x.shape[0], x.device, ROW_DTYPES[x.dtype]


def _scalar(name: str, v, dev: torch.device) -> tuple:
    """A Python number or a one-element float32 tensor on ``dev`` → the
    C interface's (pointer or None, float32 value). A tensor is read by
    the kernel on the device, so it costs no host sync."""
    if isinstance(v, Tensor):
        if v.device != dev or v.dtype != torch.float32 or v.numel() != 1:
            raise ValueError(f"{name} must be a number or a one-element "
                             f"float32 tensor on {dev}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
        return v.data_ptr(), 0.0
    if isinstance(v, numbers.Real):
        return None, float(np.float32(v))
    raise TypeError(f"{name} must be a number or a tensor, got "
                    f"{type(v).__name__}")


#: Every wrapper with a launch count: the level kernels below and the
#: scalar ones, which :func:`counted` adds when their modules are imported
#: (importing :mod:`repro_torch.kernels` imports them all).
COUNTED = []


def counted(fn):
    """Give a wrapper a launch count covered by :func:`reset_launch_counts`."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


KERNELS = tuple(map(counted, (
    cl_fuse_level_cuda, sparsify_ef_level_cuda, chain_accum_level_cuda,
    count_ge_fused_level_cuda, hist_topq_level_cuda, count_ge_level_cuda)))


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in COUNTED:
        fn.launches = 0
