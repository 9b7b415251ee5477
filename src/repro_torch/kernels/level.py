"""CUDA kernels for one level of W concurrent node steps, bound with ctypes.

The kernels live in ``csrc/level.cu`` and replace the Pallas TPU kernels of
:mod:`repro.kernels.level`:

* :func:`cl_fuse_level_cuda` ← ``cl_fuse_level_pallas`` — the whole CL
  node step (Algorithms 3/5, stragglers included);
* :func:`sparsify_ef_level_cuda` ← ``sparsify_ef_level_pallas`` — fused
  error feedback + sparsify (Algorithms 1/2/4);
* :func:`chain_accum_level_cuda` ← ``chain_accum_level_pallas`` — the IA
  combine with its support counts.

Each is bounded by device-memory bytes (see the source's header). Their
plain PyTorch versions are in :mod:`repro_torch.kernels.ref`; the
dispatching entries in :mod:`repro_torch.kernels.ops` pick one or the other
by the device of the tensors they are given.

The source is compiled with ``nvcc`` into ``build/`` at the repository root
at first use (a content-addressed shared library with a plain C interface),
then loaded with :mod:`ctypes`. Nothing is compiled or loaded at import.
Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "level.cu"
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
    """The shared library's path, named by the source's content hash."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"liblevel-{digest.hexdigest()[:12]}.so"


def build() -> str:
    """Compile ``csrc/level.cu`` if its library is missing; → nvcc's log.

    ``-Xptxas -v`` is always on, so the log lists each kernel's registers
    and shared memory. The library is written under a temporary name and
    renamed, so concurrent processes never load a half-written file.
    """
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


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
        for fn in (lib.cl_fuse_level_launch, lib.sparsify_ef_level_launch,
                   lib.chain_accum_level_launch, lib.level_tiles):
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


def _rows(name: str, t: Tensor, shape: tuple, device: torch.device):
    """A [W, d] operand, read with 16-byte loads: one that does not start
    on a 16-byte boundary (a row view inside a larger batch) is copied."""
    t = _check(name, t, shape, device)
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


KERNELS = (cl_fuse_level_cuda, sparsify_ef_level_cuda, chain_accum_level_cuda)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0
