"""Dry run: every (arch × shape × mesh) cell on fake tensors (port of
:mod:`repro.launch.dryrun`).

The reference lowers and compiles each cell's SPMD program for 256 or 512
fake devices and reads ``memory_analysis``/``cost_analysis``. The port has
no SPMD compiler; it runs its own step once under ``FakeTensorMode``, at
the config's full widths and full depth, with every rank on one fake
device (:func:`fake_device`: ``cuda:0``, or ``cpu`` where torch has no
CUDA), and counts what that run allocates and computes; a train cell runs
once more on a mesh of one fake device per rank (:func:`rank_mesh`), where
the state is placed by rank (rank (k, m) holds its shard of the params by
``param_pspecs``) and phase 1 splits each client's work over its M ranks
(tensor-parallel, or batch over model), for one rank's bytes. Nothing is computed on
any device, on the CPU or on a card:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
        --out dryrun_results.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1x1

(``--mesh 1x1``: one card instead of the production meshes.)

A record (:func:`lower_cell`) keeps the reference's keys:

* ``memory_analysis`` — per rank, the reference's program:
  ``argument_size_in_bytes`` and ``output_size_in_bytes`` are the bytes one
  rank holds of the step's arguments and outputs under their specs
  (:func:`rank_bytes`: the train state by
  :func:`~repro_torch.train.step.state_shardings`, the batch, params and
  caches by :mod:`~repro_torch.models.partition`); the outputs add XLA's 8
  bytes of tuple table a leaf, so both equal XLA's ``memory_analysis()``
  of the reference's compiled step (``argument_size_in_bytes`` leaves out
  what the reference's ``jax.jit`` drops as unread: a prefill's SSM
  states, an attention-free decode's position). ``alias_size_in_bytes`` is
  0 (the reference's dry run donates nothing). Among the devices that
  hold one rank each (every device of :func:`rank_mesh`; ``cuda:0`` of
  ranks ``cuda:0, cpu, cpu, cpu``) the one with the largest peak gives
  ``temp_size_in_bytes`` (that peak less its arguments and outputs
  there), ``peak_bytes_estimate`` (the reference's formula: arguments +
  outputs + temporaries − aliases) and ``fits_one_card`` (that estimate
  within 80 GB), and ``rank_peak_bytes`` / ``rank_peak_device`` record
  that device's peak. Where every device holds several ranks they are
  ``None``: one rank's transients are not measured there. A serving cell
  on a mesh of several ranks runs split over them
  (:mod:`~repro_torch.models.serve_split`: params by ``param_pspecs``,
  the cache by ``cache_pspecs``, rank (k, 0) doing the replicated work).
* ``device_peak_bytes`` — the fake run's peak live bytes on the mesh's
  first device, arguments included: what a card holding the whole mesh
  needs for the step (storage sizes rounded up to the CUDA caching
  allocator's 512 bytes); ``device_temp_bytes`` — that peak less the
  step's arguments and new outputs there (a serving step updates its
  caches in place); ``port_home_bytes`` (:func:`home_bytes`) — what
  :func:`~repro_torch.train.step.init_state` puts on the device that gets
  the most of the train state (on a mesh of several devices the state is
  placed by rank; ``port_device_bytes`` lists each device's bytes), or
  the same of a serving step's params and cache; ``port_fits_one_card``:
  ``device_peak_bytes`` within a card's 80 GB.
* ``flops`` (``FlopCounterMode``'s formulas), ``bytes_accessed`` (the input and
  output bytes of every non-view aten op: unfused traffic, an upper bound
  on the device's), ``collectives`` (the bytes the rotated-segment
  transport sends per rank and step, from the static plan: one payload a
  hop, compact ``(values, int32 indices)`` or a dense float32 segment; 0
  where the mesh has one DP rank) and ``roofline``: those counts over H100
  SXM spec peaks, a model with no card run behind it (the traffic is an
  upper bound, so its terms say how the traffic was counted, not what
  bounds the card).
* ``stand_ins`` — how often each stand-in below answered.

Host reads of data have no answer on fake tensors. Where the step reads
data on the host, the run answers with these stand-ins, and only at these
call sites (any other host read fails the cell with its site named):

* ``core.sparsify._select_keep`` — ``bool(isnan.any())`` → False (no NaN
  in the row) and ``int((top > kth).sum())`` → q (q survivors above the
  q-th magnitude, so no tie is broken);
* ``core.sparsify._compact_rows`` — ``nonzero(row)`` → q nonzeros (the
  first q positions of the row).

The CUDA kernels read ``data_ptr`` through ``ctypes``; the fake run takes
their plain versions (``kernel_mode="ref"``, recorded in each record), and
counts each call as the card runs the kernel: its outputs allocated, its
inputs and outputs moved once, none of the plain version's temporaries
(``kernel_calls``: the calls per kernel).
Every ``--agg`` kind with a node step runs this way, the TCS mask's τ
search included (it reads no count on the host); ``routing`` is a cost
model with no node step and gives a ``FAIL`` record.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_cells
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model as model_mod
from repro_torch.models import partition, serve_split
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train.state import TrainConfig, map_state, state_leaves
from repro_torch.train.step import (build_prefill_step, build_serve_step,
                                    build_train_step, dp_size, init_state,
                                    state_shardings)

aten = torch.ops.aten

# H100 SXM spec peaks ("NVIDIA H100 80GB HBM3, 700.00 W" data sheet)
CARD = "NVIDIA H100 80GB HBM3, 700.00 W (spec peak)"
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s, NVLink, per direction
CARD_BYTES = 80e9            # device memory
ALLOC_ROUND = 512            # the CUDA caching allocator's block granule
TUPLE_ENTRY_BYTES = 8        # XLA's output tuple table, per leaf


def default_train_config(agg_kind: str = "cl_sia",
                         fsdp: bool = False) -> TrainConfig:
    """The reference's dry-run TrainConfig; the kernels' plain versions
    (fake tensors have no ``data_ptr``)."""
    return TrainConfig(agg=AggConfig(kind=AggKind(agg_kind), q=1,
                                     kernel_mode="ref"),
                       opt=OptConfig(name="adamw", lr=3e-4),
                       q_frac=0.01, fsdp_compute=fsdp)


# ---------------------------------------------------------------------------
# Per-rank accounting
# ---------------------------------------------------------------------------

def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= mesh.shape[a]
    return n


def shard_bytes(shape, dtype: torch.dtype, spec: tuple, mesh) -> int:
    """Bytes one rank holds of a ``shape``/``dtype`` leaf under ``spec``:
    each sharded dimension divided (rounded up, as XLA pads) by the
    product of its mesh axes' sizes."""
    n = torch.empty((), dtype=dtype).element_size()
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for d, entry in zip(shape, spec):
        n *= -(-int(d) // _axes_size(mesh, entry))
    return n


def _pairs(tree, specs) -> list:
    """``(tensor, spec)`` pairs of a tree and its spec tree (NamedTuples,
    dicts, tuples of tensors; ``None`` leaves skipped)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(tree, tuple(specs))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f in tree._fields
                for p in _pairs(getattr(tree, f), getattr(specs, f))]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _pairs(tree[k], specs[k])]
    if isinstance(tree, (tuple, list)):
        return [p for t, s in zip(tree, specs) for p in _pairs(t, s)]
    raise TypeError(f"unexpected leaf {type(tree).__name__}")


def rank_bytes(tree, specs, mesh) -> int:
    """Bytes one rank holds of ``tree`` under the spec tree ``specs``."""
    return sum(shard_bytes(t.shape, t.dtype, s, mesh)
               for t, s in _pairs(tree, specs))


def _leaves(tree) -> list:
    """Every tensor of a tree (a placed state's pieces and replicas)."""
    return [t for t in state_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def mem_dict(arg: int, out: int, temp: Optional[int] = None) -> dict:
    """The reference's ``memory_analysis`` keys, per rank; without one
    rank's transients (``temp``), its peak is not measured (``None``)."""
    return {"argument_size_in_bytes": int(arg),
            "output_size_in_bytes": int(out),
            "temp_size_in_bytes": None if temp is None else int(temp),
            "alias_size_in_bytes": 0,
            "peak_bytes_estimate": (None if temp is None else
                                    int(arg) + int(out) + int(temp))}


# ---------------------------------------------------------------------------
# The fake run: live bytes, traffic and the stand-ins
# ---------------------------------------------------------------------------

_STAND_INS = {
    # (function, what) → the stand-in's name in the record
    ("_select_keep", "bool"): "_select_keep: no NaN",
    ("_select_keep", "int"): "_select_keep: q survivors",
    ("_compact_rows", "nonzero"): "_compact_rows: q nonzeros",
}


class HostReadError(RuntimeError):
    """A host read of tensor data with no stand-in at its call site."""


def _site(func_names) -> tuple:
    """→ (function name, its frame's locals) of the innermost caller whose
    name is one of ``func_names``, or (the innermost repro_torch frame's
    ``file:line``, None)."""
    f = sys._getframe(2)
    first = None
    while f is not None:
        code = f.f_code
        if code.co_name in func_names:
            return code.co_name, f.f_locals
        if first is None and "repro_torch" in code.co_filename \
                and "dryrun" not in code.co_filename:
            first = (f"{os.path.relpath(code.co_filename)}:{f.f_lineno} "
                     f"({code.co_name})")
        f = f.f_back
    return first or "?", None


_HOST_READS = (aten._local_scalar_dense.default, aten.nonzero.default)


def _tensor_bytes(xs) -> int:
    """Bytes of the tensors among ``xs`` (and one level of lists)."""
    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            n += _tensor_bytes(x)
    return n


class LiveBytes(TorchDispatchMode):
    """Live storage bytes per device under a fake run: each new storage an
    op makes adds its size (rounded up to ``ALLOC_ROUND``), and its release
    takes it away. Also sums every non-view op's input and output bytes,
    counts FLOPs by ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``), and answers the host
    reads of :data:`_STAND_INS`."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        super().__init__()
        self.live: dict = collections.Counter()
        self.peak: dict = collections.Counter()
        self.bytes_accessed = 0
        self.flops = 0
        self.stand_ins: dict = collections.Counter()
        self._refs: dict = {}
        self._flop_fns = flop_registry
        self._is_view: dict = {}
        self._composite: dict = {}
        self.paused = 0
        self.kernel_calls: dict = collections.Counter()

    # -- storages ----------------------------------------------------------
    def _release(self, key, dev, nb, _ref):
        self._refs.pop(key, None)
        self.live[dev] -= nb

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        ref = self._refs.get(key)
        if ref is not None and ref() is st:
            return
        nb = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        dev = str(t.device)
        self._refs[key] = weakref.ref(
            st, lambda r, k=key, d=dev, n=nb: self._release(k, d, n, r))
        self.live[dev] += nb
        if self.live[dev] > self.peak[dev]:
            self.peak[dev] = self.live[dev]

    def _outputs(self, out, args, kwargs, moved: bool = True) -> None:
        """Track ``out``'s new storages; with ``moved``, add the inputs'
        and outputs' bytes to the traffic."""
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor):
                self.track(o)
        if moved:
            self.bytes_accessed += (_tensor_bytes(args)
                                    + _tensor_bytes(kwargs.values())
                                    + _tensor_bytes(outs))

    def reset(self) -> None:
        """Peaks from the live bytes now; traffic, FLOPs and kernel calls
        from 0."""
        self.peak = collections.Counter(self.live)
        self.bytes_accessed = 0
        self.flops = 0
        self.kernel_calls.clear()

    def kernel(self, name: str, args, kwargs, out) -> None:
        """A kernel's plain version returned ``out``: count it as the CUDA
        kernel runs — its outputs allocated, its inputs and outputs moved
        once — and none of the plain version's temporaries."""
        if self.paused:
            return
        self._outputs(out, args, kwargs)
        self.kernel_calls[name] += 1

    # -- dispatch ----------------------------------------------------------
    def _stand_in(self, func, args):
        x = args[0]
        if func is aten._local_scalar_dense.default:
            what = "bool" if x.dtype == torch.bool else (
                "int" if not x.dtype.is_floating_point else "float")
        else:
            what = "nonzero"
        name, local = _site({fn for fn, _ in _STAND_INS})
        key = (name, what)
        if key not in _STAND_INS:
            raise HostReadError(
                f"host read ({func.__name__} of a {x.dtype} tensor) at "
                f"{name} has no stand-in on fake tensors")
        self.stand_ins[_STAND_INS[key]] += 1
        q = int(local["q"])
        if what == "bool":
            return False
        if what == "int":
            return q
        n = min(q, x.numel())
        return torch.empty((n, x.dim()), dtype=torch.int64, device=x.device)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import (
            DataDependentOutputException, DynamicOutputShapeException)
        kwargs = kwargs or {}
        composite = self._composite.get(func)
        if composite is None:
            composite = self._composite[func] = (
                func.namespace == "aten"
                and func.overloadpacket not in self._flop_fns
                and func.has_kernel_for_dispatch_key(
                    torch._C.DispatchKey.CompositeImplicitAutograd))
        if composite:
            # a composite op reaches the mode whole under inference_mode;
            # run its parts through the mode, as the card runs them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if func in _HOST_READS:
            try:
                out = func(*args, **kwargs)
            except (DataDependentOutputException,
                    DynamicOutputShapeException):
                out = self._stand_in(func, args)
        else:
            out = func(*args, **kwargs)
        if self.paused:
            return out
        view = self._is_view.get(func)
        if view is None:
            view = self._is_view[func] = bool(func.is_view)
        # a prim op (a tensor's device) moves no bytes
        self._outputs(out, args, kwargs,
                      moved=not view and func.namespace == "aten")
        flop_fn = self._flop_fns.get(func.overloadpacket)
        if flop_fn is not None:
            self.flops += flop_fn(*args, **kwargs, out_val=out)
        return out


#: The plain versions (``repro_torch.kernels.ref``) of the CUDA kernels.
KERNELS = ("ref_cl_fuse_level", "ref_sparsify_ef_level",
           "ref_chain_accum_level", "ref_count_ge_fused_level",
           "ref_hist_topq_level", "ref_count_ge_level", "ref_chain_accum",
           "ref_cl_fuse", "ref_sparsify_ef", "ref_count_ge",
           "ref_count_ge_fused", "ref_cl_fuse_select_level",
           "ref_tau_search_fused_level", "ref_ia_fuse_select_level")


@contextlib.contextmanager
def _as_kernels(live: LiveBytes):
    """Within the block each kernel's plain version counts as its CUDA
    kernel (:meth:`LiveBytes.kernel`): the card runs the kernel, which
    allocates its outputs and nothing else."""
    from repro_torch.kernels import ref
    saved = {name: getattr(ref, name) for name in KERNELS}

    def as_kernel(name, fn):
        def kernel(*args, **kwargs):
            live.paused += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                live.paused -= 1
            live.kernel(name.removeprefix("ref_"), args, kwargs, out)
            return out
        return kernel

    for name, fn in saved.items():
        setattr(ref, name, as_kernel(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


@contextlib.contextmanager
def _own_schedules():
    """Keep the segment schedules a fake run builds (their index pools are
    fake tensors) out of the port's schedule cache."""
    from repro_torch.agg import device as agg_device
    before = set(agg_device._SCHEDULES)
    try:
        yield
    finally:
        for key in set(agg_device._SCHEDULES) - before:
            del agg_device._SCHEDULES[key]


def fake_device() -> str:
    """The device the ranks claim by default: ``cuda:0`` where torch has
    CUDA. A fake CUDA tensor needs the CUDA runtime for its device guards
    (indexing, autograd), so where there is none the ranks claim ``cpu``;
    the step takes the same path on either (its kernels run their plain
    versions) and allocates the same storages."""
    return "cuda:0" if torch.cuda.is_available() else "cpu"


def _materialize(tree, device):
    """Empty tensors of ``tree``'s shapes and dtypes on ``device`` (fake
    under a fake mode); nothing is drawn."""
    return map_state(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                           device=device), tree)


# ---------------------------------------------------------------------------
# Roofline (the reference's benchmarks/roofline.py, H100 SXM peaks)
# ---------------------------------------------------------------------------

def model_flops_for(cfg: ModelConfig, shape: ShapeSpec, kind: str) -> float:
    """6·N_active·tokens (train), 2·N_active·tokens (fwd-only prefill),
    2·N_active·batch (one decode token)."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: 1 token/seq


@dataclasses.dataclass
class Roofline:
    """The reference's roofline terms from the fake run's counts and H100
    SXM spec peaks: a model, not a measurement (no card run stands behind
    it, and ``bytes_accessed`` is unfused op traffic, an upper bound)."""
    flops: float                 # per chip
    bytes_accessed: float        # per chip
    wire_bytes: float            # per chip
    model_flops: float           # 6·N(_active)·tokens — useful-compute ref
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        t_dom = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_dom if t_dom else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "wire_bytes_per_chip": self.wire_bytes,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peaks": CARD,
            "measured": False,
        }


def ring_wire_bytes(step) -> dict:
    """Bytes the rotated-segment transport sends per rank and train step,
    from the step's static plan: every real slot whose parent is another
    rank (or the segment's PS on another rank) sends one payload — ``q``
    compact values and int32 indices, or the dense float32 segment."""
    from repro_torch.agg.device import _segments_compact, _wire_budget
    plan, k, cfg = step.plan, step.k_dp, step.agg_cfg
    out = {"collective_permute": 0.0, "count": 0, "format": "none"}
    if k == 1 or step.nested is not None:
        out["total"] = 0.0
        return out
    seg = step.seg
    compact = _segments_compact(cfg, seg, plan, True, "auto", True)
    if compact:
        q = _wire_budget(cfg)
        payload = q * (torch.empty((), dtype=getattr(
            torch, cfg.wire_dtype)).element_size() + 4)
    else:
        payload = seg * 4
    mask = np.asarray(plan.slot_mask) > 0
    node = np.asarray(plan.node_id)[mask]
    par = np.asarray(plan.parent_row)[mask]
    # segment s relabels position c to rank (c + s) % k and puts its PS on
    # rank s, so each rank sends, over the k segments, once per slot with
    # a rank parent and once per delivery to the PS but from position 0
    per_rank = int(np.sum(par < k) + np.sum((par >= k) & (node != 0)))
    out.update(collective_permute=per_rank * payload, count=per_rank,
               format="compact" if compact else "dense",
               total=per_rank * payload)
    return out


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _serve_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> tuple:
    """→ (meta arguments, their specs, the arguments the reference's
    compiled step keeps, output specs) of a prefill or decode step, sharded
    as the reference's dry run shards them.

    ``jax.jit`` drops the arguments its program never reads
    (``keep_unused=False``): the SSM states of a prefill (the reference's
    prefill starts every state from zero) and the decode position of an
    attention-free stack. The kept arguments leave them out (``None``); the
    port still allocates them, and the fake run counts them on the device.
    """
    dpx = partition.batch_axes(mesh)
    bspec = dpx if shape.global_batch % dp_size(mesh) == 0 else None
    p_specs = partition.param_pspecs(cfg, mesh)
    c_specs = partition.cache_pspecs(cfg, mesh, shape.global_batch)
    params = model_mod.param_specs(cfg)
    if shape.kind == "prefill":
        ins = specs_mod.prefill_specs(cfg, shape)
        args = [params, ins["cache"], ins["tokens"]]
        specs = [p_specs, c_specs, (bspec, None)]
        if "extra" in ins:
            args.append(ins["extra"])
            specs.append({k: (bspec,) + (None,) * (v.dim() - 1)
                          for k, v in ins["extra"].items()})
        kept = list(args)
        kept[1] = {site: {k: (None if k == "state" else v)
                          for k, v in leaves.items()}
                   for site, leaves in ins["cache"].items()}
    else:
        ins = specs_mod.decode_specs(cfg, shape)
        args = [params, ins["cache"], ins["token"], ins["pos"]]
        specs = [p_specs, c_specs, (bspec,), ()]
        kept = list(args)
        if cfg.family == "ssm":
            kept[3] = None
    return args, specs, kept, [(bspec,), c_specs]


def _meta_mesh(mesh):
    return make_mesh(tuple(mesh.axis_sizes), mesh.axis_names,
                     ["meta"] * mesh.size)


def rank_mesh(mesh):
    """``mesh``'s shape and axes with one fake device per rank, ``cpu:r``
    for rank r (a fake CPU tensor keeps its index; a ``cuda:r`` mesh would
    need r + 1 cards). A device index is 8 bits (``cpu:256`` is ``cpu:0``,
    ``cpu:255`` is ``cpu``), so ranks from the 256th on share ``cpu`` with
    rank 255: on 2 × 16 × 16 the first pod's ranks but its last hold one
    rank each, rank (0, 0) among them."""
    return make_mesh(tuple(mesh.axis_sizes), mesh.axis_names,
                     [f"cpu:{r}" if r < 255 else "cpu"
                      for r in range(mesh.size)])


def _phase1_once(step, state, batch, live) -> tuple:
    """``step.phase1`` on fake tensors with client 0's work run once: every
    client runs the same shapes, so each client's transients and counts
    are client 0's. The other clients' gradient columns are allocated
    first, as their own phase 1 leaves them, so a device that holds every
    rank holds them all at client 0's peak, as at the last client's; the
    FLOPs and op traffic count client 0's K_dp times. Peaks and FLOPs equal
    the full phase 1's; so does the traffic on a mesh of one device, where
    on several it misses each other client's batch copy to its rank (k, 0)
    (client 0's batch is on that device already: 512 bytes a client at
    SMOKE size, of 1.3 GB)."""
    from repro_torch.train.step import rank_device

    traffic = live.bytes_accessed
    cols = [None] + [[torch.empty((step.layout.n_local,), dtype=step.agg_dt,
                                  device=rank_device(step.mesh, k, m))
                      for m in range(step.m)] for k in range(1, step.k_dp)]
    losses = [None] + [torch.empty((), dtype=torch.float32,
                                   device=rank_device(step.mesh, k, 0))
                       for k in range(1, step.k_dp)]
    live.bytes_accessed = traffic
    flops = live.flops
    cols[0], losses[0] = step.client_cols(state.params, batch, 0)
    live.flops += (step.k_dp - 1) * (live.flops - flops)
    live.bytes_accessed += (step.k_dp - 1) * (live.bytes_accessed - traffic)
    return cols, step._mean_loss(losses)


def _serve_apart(cfg: ModelConfig, shape: ShapeSpec, mesh) -> bool:
    """Do a split serving cell's DP groups share no work (several groups,
    and no MoE routed over the gathered batch)? Then
    :func:`_serve_once` runs it."""
    sp = serve_split.ServeSplit(cfg, mesh, shape.global_batch, shape.seq_len)
    tokens = sp.per * (shape.seq_len if shape.kind == "prefill" else 1)
    return sp.n_groups > 1 and (cfg.family != "moe"
                                or sp.routes_per_group(tokens))


def _serve_once(cfg: ModelConfig, shape: ShapeSpec, args: list,
                live) -> tuple:
    """A split serving step (``args``: placed params, placed cache, each
    group's inputs) on fake tensors with DP group 0's work run once, where
    the groups share no work (:func:`_serve_apart`): every group serves
    the same shapes, so group 0's transients and counts are each group's.

    Group 0 runs as a split of its own: its ranks' devices as a mesh with
    ``model`` alone, its requests, and its cache blocks (``cache_pspecs``
    restricted to it are the same blocks). The other groups' activations
    are allocated first on their ranks (k, 0), as their own runs hold them
    beside group 0's; after the run their logits are allocated there,
    copied to the first device and joined with group 0's, as the split
    step's are. The FLOPs and op traffic of group 0's run count
    ``n_groups`` times. → the step's (next tokens, cache)."""
    from repro_torch.train.state import RankCache
    params, cache, *ins = args
    sp = cache.split
    sub_mesh = make_mesh(
        tuple(sp.m if a == "model" else 1 for a in sp.mesh.axis_names),
        sp.mesh.axis_names, [sp.device(0, m) for m in range(sp.m)])
    live.paused += 1                     # its cache specs are meta tensors
    sub = serve_split.ServeSplit(cfg, sub_mesh, sp.per, sp.max_len)
    live.paused -= 1
    trees = [None] * len(sub.tree_devices)
    for r in range(sub_mesh.size):
        trees[sub.index[r]] = cache.rank(sp.group_ranks[0][r])
    for tree, blocks in zip(trees, sub.tree_blocks):
        for x, leaf, dims in zip(_leaves(tree), _leaves(sub.whole), blocks):
            assert tuple(x.shape) == tuple(
                -(-n // c) for n, (_, c) in zip(leaf.shape, dims)), (
                "group 0's cache blocks are not its own split's")
    tokens = ins[0][:1]
    width = tokens[0].shape[1] if shape.kind == "prefill" else 1
    traffic = live.bytes_accessed
    rest = [torch.empty((sp.per, width, cfg.d_model), dtype=cfg.dtype,
                        device=sp.device(g, 0))
            for g in range(1, sp.n_groups)]
    live.bytes_accessed = traffic
    flops = live.flops
    with torch.inference_mode():
        if shape.kind == "prefill":
            extra = {k: v[:1] for k, v in (ins[1:] or [{}])[0].items()}
            logits, _ = sub.prefill(params, RankCache(trees, sub), tokens,
                                    extra)
        else:
            logits, _ = sub.decode(params, RankCache(trees, sub), tokens,
                                   shape.seq_len - 1)
        live.flops += (sp.n_groups - 1) * (live.flops - flops)
        live.bytes_accessed += (sp.n_groups - 1) * (live.bytes_accessed
                                                    - traffic)
        del rest
        traffic = live.bytes_accessed
        others = [torch.empty_like(logits, device=sp.device(g, 0))
                  for g in range(1, sp.n_groups)]
        live.bytes_accessed = traffic
        logits = sp.join([logits] + others)
        del others
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def device_state_bytes(cfg: ModelConfig, tc: TrainConfig, mesh,
                       **init_kw) -> dict:
    """Bytes of the train state that
    :func:`~repro_torch.train.step.init_state` (given ``init_kw``:
    ``topology``, ``cohorts``) puts on each device of ``mesh``
    (``str(device)`` → bytes, in the mesh's order); on a mesh of several
    devices from an init on fake tensors (nothing is drawn)."""
    if len(mesh.distinct()) == 1:
        return {str(mesh.devices[0]): _nbytes(
            init_state(cfg, tc, _meta_mesh(mesh), None, **init_kw))}
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = {str(d): 0 for d in mesh.distinct()}
    with FakeTensorMode(allow_non_fake_inputs=True):
        for t in _leaves(init_state(cfg, tc, mesh, None, **init_kw)):
            out[str(t.device)] += t.numel() * t.element_size()
    return out


def serve_device_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """Bytes of a serving step's params and cache on each device of
    ``mesh`` (``str(device)`` → bytes): whole on a mesh of one rank, placed
    by rank on a mesh of several (from a placement on fake tensors)."""
    if not serve_split.is_split(mesh):
        return {str(mesh.devices[0]): _nbytes([
            model_mod.param_specs(cfg), model_mod.cache_specs(
                cfg, shape.global_batch, shape.seq_len)])}
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = {str(d): 0 for d in mesh.distinct()}
    seen = set()
    with FakeTensorMode(allow_non_fake_inputs=True):
        for t in _leaves(_placed_serve_args(cfg, shape, mesh)):
            key = id(t.untyped_storage())
            if key not in seen:
                seen.add(key)
                out[str(t.device)] += t.numel() * t.element_size()
    return out


def _placed_serve_args(cfg: ModelConfig, shape: ShapeSpec, mesh) -> list:
    """A serving step's params and cache placed on ``mesh`` (empty params
    drawn nowhere: under a fake mode nothing is allocated)."""
    params = _materialize(model_mod.param_specs(cfg), mesh.devices[0])
    return [serve_split.place_params(params, cfg, mesh),
            serve_split.init_cache(cfg, mesh, shape.global_batch,
                                   shape.seq_len)]


def _placed_inputs(spec, cfg: ModelConfig, shape: ShapeSpec, mesh):
    """A split serving step's input (tokens, or the frontend inputs'
    dict) as each DP group's requests on its rank (k, 0), made in place
    (``ServeSplit.place_inputs``; a decode's position stays a host int)."""
    if isinstance(spec, dict):
        return {k: _placed_inputs(v, cfg, shape, mesh)
                for k, v in spec.items()}
    if not spec.dim():
        return _materialize(spec, mesh.devices[0])
    sp = serve_split.ServeSplit(cfg, mesh, shape.global_batch, shape.seq_len)
    return tuple(torch.empty((sp.per, *spec.shape[1:]), dtype=spec.dtype,
                             device=sp.device(g, 0))
                 for g in range(sp.n_groups))


def home_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh,
               tc: Optional[TrainConfig] = None) -> int:
    """``port_home_bytes`` with no fake run of the step: the bytes of the
    step's arguments that the port puts on one device — the train state on
    the device that gets the most of it
    (:func:`~repro_torch.train.step.init_state`; the whole state where the
    mesh has one device), or a serving step's params and cache. That
    device's peak is at least this."""
    if shape.kind == "train":
        tc = default_train_config() if tc is None else tc
        return max(device_state_bytes(cfg, tc, mesh).values())
    return max(serve_device_bytes(cfg, shape, mesh).values())


def dry_run_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 tc: Optional[TrainConfig] = None, *,
                 agg_kind: str = "cl_sia") -> dict:
    """Run one cell's step once on fake tensors; → the record's measured
    part (``memory_analysis``, ``device_peak_bytes``, ``port_home_bytes``,
    ``flops``, ``bytes_accessed``, ``collectives``, ``stand_ins``, …).

    ``mesh`` is a :class:`~repro_torch.launch.mesh.Mesh`; its devices are
    claimed by fake tensors, never touched. ``tc`` defaults to
    :func:`default_train_config` of ``agg_kind``; its kernels run their
    plain versions. The step is the port's own (``build_train_step``,
    ``build_prefill_step``, ``build_serve_step``), built with its plans
    and layout before the fake mode; its arguments are empty tensors of
    the specs' shapes on the mesh's first device, where ``init_state``
    and the serving loop put them — but for a train state on a mesh of
    several devices, which ``init_state`` places by rank on fake tensors.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    tc = default_train_config(agg_kind) if tc is None else tc
    if tc.agg.kernel_mode != "ref":
        tc = dataclasses.replace(
            tc, agg=dataclasses.replace(tc.agg, kernel_mode="ref"))
    home = str(mesh.devices[0])
    rec: dict = {"device": home, "kernel_mode": "ref"}
    placed = shape.kind == "train" and len(mesh.distinct()) > 1
    # a serving step on several ranks takes its params and cache placed
    split = shape.kind != "train" and serve_split.is_split(mesh)
    apart = split and _serve_apart(cfg, shape, mesh)
    # a device that holds one rank: its transients are that rank's
    held = collections.Counter(str(d) for d in mesh.devices)
    solo = [d for d in held if held[d] == 1]
    if shape.kind == "train":
        step = build_train_step(cfg, tc, mesh)
        args = [init_state(cfg, tc, _meta_mesh(mesh), None),
                specs_mod.train_batch_specs(cfg, shape)]
        specs = [state_shardings(cfg, tc, mesh),
                 partition.batch_pspecs(cfg, mesh, shape.global_batch)]
        kept = args
        rec["collectives"] = ring_wire_bytes(step)
        # the step's host inputs (default weights and participation), as
        # its __call__ makes them, before the fake mode
        _, weights, participate = step.round_inputs({})
    else:
        args, specs, kept, out_specs = _serve_inputs(cfg, shape, mesh)
        fn = (build_prefill_step(cfg, mesh) if shape.kind == "prefill"
              else build_serve_step(cfg, mesh))
        rec["collectives"] = {"collective_permute": 0.0, "count": 0,
                              "format": "none", "total": 0.0}
    per_dev = (device_state_bytes(cfg, tc, mesh) if shape.kind == "train"
               else serve_device_bytes(cfg, shape, mesh))
    rec["port_home_bytes"] = max(per_dev.values())
    rec["port_device_bytes"] = list(per_dev.values())
    live = LiveBytes()
    with _own_schedules(), _as_kernels(live), \
            FakeTensorMode(allow_non_fake_inputs=True), live:
        if split:
            fake = (_placed_serve_args(cfg, shape, mesh)
                    + [_placed_inputs(a, cfg, shape, mesh)
                       for a in args[2:]])
        else:
            fake = [_materialize(a, home) for a in args]
        if placed:
            fake[0] = init_state(cfg, tc, mesh, None)
        arg_devs = collections.Counter(live.live)
        entry = {id(t.untyped_storage()) for t in _leaves(fake)}
        live.reset()
        if shape.kind == "train":
            cols, loss = _phase1_once(step, *fake, live)
            out = step.finish(fake[0], cols, loss, weights, participate)
            del cols, loss
            out_specs = [specs[0], {k: () for k in out[1]}]
        else:
            if apart:
                out = _serve_once(cfg, shape, fake, live)
            elif shape.kind == "prefill":
                out = fn(*fake)
            else:                              # the host knows the position
                out = fn(*fake[:3], shape.seq_len - 1)
        del fake
        # the outputs' new storages (a serving step's caches are its
        # arguments, updated in place)
        new = {id(t.untyped_storage()): (str(t.device),
                                         t.untyped_storage().nbytes())
               for t in _leaves(out)}
        out_devs = collections.Counter()
        for key, (dev, nb) in new.items():
            if key not in entry:
                out_devs[dev] += nb
        peaks = collections.Counter(live.peak)
    # a placed output state (or cache) has the input's global shapes
    out_global = ([kept[0], out[1]] if placed else
                  [out[0], args[1]] if split else out)
    arg = sum(rank_bytes(a, s, mesh) for a, s in zip(kept, specs))
    outb = (sum(rank_bytes(o, s, mesh) for o, s in zip(out_global,
                                                        out_specs))
            + TUPLE_ENTRY_BYTES * len(_leaves(out_global)))
    temp = None
    if solo:
        # one rank's transients, from the rank device with the largest peak
        top = max(solo, key=peaks.get)
        temp = max(0, peaks[top] - arg_devs[top] - out_devs[top])
        rec.update(rank_peak_device=top, rank_peak_bytes=int(peaks[top]))
    peak, arg_dev, out_dev = peaks[home], arg_devs[home], out_devs[home]
    mem = mem_dict(arg, outb, temp)
    if solo:
        rec["fits_one_card"] = mem["peak_bytes_estimate"] <= CARD_BYTES
    rec.update(memory_analysis=mem,
               device_peak_bytes=int(peak),
               device_temp_bytes=int(max(0, peak - arg_dev - out_dev)),
               device_argument_bytes=int(arg_dev),
               device_output_bytes=int(out_dev),
               flops=float(live.flops),
               bytes_accessed=float(live.bytes_accessed),
               bytes_accessed_note=("sum of input and output bytes per aten "
                                    "op (unfused traffic; an upper bound)"),
               stand_ins=dict(live.stand_ins),
               kernel_calls=dict(live.kernel_calls))
    return rec


def mesh_name(multi_pod: bool, shape=None) -> str:
    if shape is not None:
        return "x".join(str(n) for n in shape)
    return "2x16x16" if multi_pod else "16x16"


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               agg_kind: str = "cl_sia", fsdp: bool = False,
               verbose: bool = True, mesh_shape=None) -> dict:
    """Dry-run one cell; return the §Dry-run/§Roofline record.

    The mesh is the production one (16×16, or 2×16×16 with ``multi_pod``)
    unless ``mesh_shape`` gives another ((data, model) or (pod, data,
    model); ``(1, 1)`` is one card), every rank on :func:`fake_device`."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if mesh_shape is None:
        devices = [fake_device()] * (512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, devices=devices)
    else:
        mesh_shape = tuple(mesh_shape)
        axes = ("data", "model") if len(mesh_shape) == 2 else (
            "pod", "data", "model")
        mesh = make_mesh(mesh_shape, axes,
                         [fake_device()] * math.prod(mesh_shape))
    tc = default_train_config(agg_kind, fsdp)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": mesh_name(multi_pod, mesh_shape),
           "agg": agg_kind, "status": "ok"}
    t0 = time.time()
    got = dry_run_cell(cfg, shape, mesh, tc)
    t_trace = time.time() - t0
    if mesh.size > 1:
        # one rank's share: placed by rank, one device a rank
        t1 = time.time()
        per = dry_run_cell(cfg, shape, rank_mesh(mesh), tc)
        got.update({k: per[k] for k in (
            "memory_analysis", "port_home_bytes", "port_device_bytes",
            "fits_one_card", "rank_peak_bytes", "rank_peak_device")},
            rank_trace_s=round(time.time() - t1, 1))
    mf = model_flops_for(cfg, shape, shape.kind)
    rl = Roofline(flops=got["flops"] / mesh.size,
                  bytes_accessed=got["bytes_accessed"] / mesh.size,
                  wire_bytes=got["collectives"]["total"],
                  model_flops=mf, chips=mesh.size)
    rec.update({"trace_s": round(t_trace, 1), "fits_one_card": None, **got,
                "port_fits_one_card": got["device_peak_bytes"] <= CARD_BYTES,
                "roofline": rl.as_dict()})
    if verbose:
        mem = rec["memory_analysis"]
        rank = mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        print(f"[{rec['mesh']}] {arch} × {shape_name}: "
              f"rank args + outputs {rank / 1e9:.2f} GB, "
              f"one-device peak {rec['device_peak_bytes'] / 1e9:.2f} GB, "
              f"flops/chip={rl.flops:.3e}, "
              f"wire={rl.wire_bytes / 1e6:.1f} MB, "
              f"spec-peak model: bottleneck={rl.bottleneck}, "
              f"roofline={rl.roofline_fraction:.3f} (trace {t_trace:.0f}s)")
        print(f"  memory_analysis: {mem}")
        if mem["peak_bytes_estimate"] is not None:
            print(f"  one rank: fullest device's state "
                  f"{rec['port_home_bytes'] / 1e9:.2f} GB, peak "
                  f"{rec['rank_peak_bytes'] / 1e9:.2f} GB on "
                  f"{rec['rank_peak_device']}, estimate "
                  f"{mem['peak_bytes_estimate'] / 1e9:.2f} GB, fits one card "
                  f"{rec['fits_one_card']}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, nargs="+")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--agg", default="cl_sia")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="another mesh than the production ones, e.g. 1x1 "
                         "(one card) or 2x2 (data x model)")
    args = ap.parse_args(argv)

    existing = {}
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for r in json.load(f):
                existing[(r["arch"], r["shape"], r["mesh"], r.get("agg"))] = r

    cells = []
    if args.all:
        for arch in ARCHS:
            cfg = get_config(arch)
            for shape_name in shape_cells(cfg):
                cells.append((arch, shape_name))
    else:
        for arch in args.arch or ["mamba2-130m"]:
            names = ([args.shape] if args.shape
                     else shape_cells(get_config(arch)))
            cells += [(arch, s) for s in names]

    custom = (tuple(int(n) for n in args.mesh.split("x")) if args.mesh
              else None)
    meshes = ([False] if custom else
              [False, True] if args.both_meshes else [args.multi_pod])
    results = list(existing.values())
    failures = 0
    for arch, shape_name in cells:
        for mp in meshes:
            key = (arch, shape_name, mesh_name(mp, custom), args.agg)
            if key in existing:
                print(f"skip cached {key}")
                continue
            try:
                rec = lower_cell(arch, shape_name, multi_pod=mp,
                                 agg_kind=args.agg, fsdp=args.fsdp,
                                 mesh_shape=custom)
            except Exception as e:  # a failure here is a bug in our system
                failures += 1
                rec = {"arch": arch, "shape": shape_name,
                       "mesh": mesh_name(mp, custom),
                       "agg": args.agg, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}"}
                print(f"FAIL {arch} × {shape_name} ({rec['mesh']}): "
                      f"{rec['error']}")
                traceback.print_exc()
            results.append(rec)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    print(f"\n{len(results)} cells, {failures} failures")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
