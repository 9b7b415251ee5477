"""Attention split by query sequence over ``model`` where the heads do not
divide M (``repro_torch.models.attention.query_blocks``) against the
reference's ``_constrain_scores`` placement.

* **Placement** (a): a reference subprocess compiles the jitted train step
  of a 1-layer f32 dense model (``d_model`` = 16 · heads, head dim 16,
  ``d_ff`` 128, vocabulary 256, CL-SIA, batch 8 × S) on a (2, 4) ``data ×
  model`` mesh of 8 fake XLA devices and reads the per-device score
  tensors ``f32[b, kv, g, Sq, S]`` from the partitioned HLO text. The
  port's step on one fake device a rank (``dryrun.rank_mesh``) makes the
  same per-rank score tensors: 6 q heads / 2 kv heads at S = 32 (neither
  head dim divides 4) → ``[4, 2, 3, 8, 32]`` on every rank, no ``[…, 32,
  32]`` one; 8 / 4 at S = 32 (the kv heads divide) → the head split ``[4,
  1, 2, 32, 32]`` on every rank; 6 / 2 at S = 30 (4 does not divide S, so
  the reference pins nothing) → the whole ``[4, 2, 3, 30, 30]``, on rank
  (k, 0) alone in the port (its replicated work runs once).
* **The step** (b): the port's step on ``["cpu"] * 8`` ranks from the
  reference's state equals the reference's jitted step at S = 32 (the
  split) and S = 30 (the whole form), f32: the loss to rtol 1e-5, the
  support equal but for swaps at a tie, the change of master and params
  to 1e-3 of its scale (``_torch_train.assert_step_close``).
* **The rule** (c): ``query_blocks`` over head counts, M, lengths and the
  blocked threshold.
* **Rank (0, 0)'s peak** (d): the dry run of phi4 SMOKE's step (6 q
  heads, 2 kv heads, batch 8 × 512) on one fake device a rank of (2, 4)
  puts rank (0, 0)'s peak at least one client's whole f32 score tensor
  below the parent's form (``query_blocks`` → 1: the sub-layer whole on
  rank (k, 0)).
"""

import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_train import (TINY, assert_same_support, assert_step_close,
                          batch_of, case, loose_coordinates, port_leaves,
                          ref_state, start_reference, tokens)
from conftest import SRC
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention
from repro_torch.models.attention import query_blocks
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, build_train_step, init_state

torch.set_num_threads(1)

MESH = (2, 4)
BATCH = 8
# name → (q heads, kv heads, S, the per-rank score shape, on which ranks m)
PLACEMENT = {
    "6/2 S=32": (6, 2, 32, (4, 2, 3, 8, 32), range(4)),
    "8/4 S=32": (8, 4, 32, (4, 1, 2, 32, 32), range(4)),
    "6/2 S=30": (6, 2, 30, (4, 2, 3, 30, 30), range(1)),
}
STEP_CASES = ("6/2 S=32", "6/2 S=30")


def _tiny(heads: int, kv: int) -> dict:
    return dict(TINY, num_layers=1, num_heads=heads, num_kv_heads=kv,
                d_model=16 * heads)


PROBE = r"""
import json, re, sys
import jax, jax.numpy as jnp
from repro import compat
from repro.configs.base import ModelConfig
from repro.core.algorithms import AggConfig, AggKind
from repro.optim.optimizers import OptConfig
from repro.train.state import TrainConfig
from repro.train import build_train_step, init_state, state_shardings

out = {}
for name, (tiny, s) in json.loads(CASES).items():
    cfg = ModelConfig(**tiny)
    tc = TrainConfig(agg=AggConfig(kind=AggKind.CL_SIA, q=1,
                                   kernel_mode="ref"),
                     opt=OptConfig(name="sgd", lr=1e-2), q_frac=0.05,
                     agg_dtype="float32", ef_dtype="float32")
    mesh = compat.make_mesh(tuple(MESH), ("data", "model"))
    with compat.set_mesh(mesh):
        st = jax.device_put(init_state(cfg, tc, mesh, jax.random.PRNGKey(0)),
                            state_shardings(cfg, tc, mesh))
        batch = {k: jnp.zeros((BATCH, s), jnp.int32)
                 for k in ("tokens", "labels")}
        text = jax.jit(build_train_step(cfg, tc, mesh)).lower(
            st, batch).compile().as_text()
    out[name] = sorted({m.group(1) for m in re.finditer(
        r"f32\[(\d+,\d+,\d+,\d+,%d)\]" % s, text)})
print(json.dumps(out))
"""


def _compiled_shapes() -> dict:
    """The reference's per-device 5-D f32 shapes ending in S, by case."""
    cases = {name: (_tiny(h, kv), s)
             for name, (h, kv, s, _, _) in PLACEMENT.items()}
    script = (f"CASES = {json.dumps(json.dumps(cases))}\nMESH = {MESH!r}\n"
              f"BATCH = {BATCH}\n" + PROBE)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    return {name: {tuple(int(n) for n in dims.split(",")) for dims in v}
            for name, v in got.items()}


def _step_case(name: str) -> dict:
    heads, kv, _, _, _ = PLACEMENT[name]
    c = case(name, mesh=MESH, steps=1)
    c["tiny"] = _tiny(heads, kv)
    return c


@pytest.fixture(scope="module")
def reference():
    """The placement probe and the reference's steps, side by side."""
    cases = [_step_case(n) for n in STEP_CASES]
    inp = {}
    for i, c in enumerate(cases):
        toks, labels = tokens(500 + i, TINY["vocab_size"],
                              (BATCH, PLACEMENT[c["name"]][2]))
        inp[f"{c['name']}/tokens/0"] = toks
        inp[f"{c['name']}/labels/0"] = labels
    pool = ThreadPoolExecutor(max_workers=1)
    probe = pool.submit(_compiled_shapes)
    pool.shutdown(wait=False)
    return probe, start_reference(cases, inp), inp


def _scores(shapes, heads: int, kv: int, s: int) -> set:
    """The score tensors ``[b, kv', g', Sq, S]`` among 5-D shapes: the
    client's batch, kv and group dims whole or split over M, Sq = S or
    S / M."""
    m, b = MESH[1], BATCH // MESH[0]

    def ways(n):
        return {n, n // m} if n % m == 0 else {n}

    g = heads // kv
    return {t for t in shapes if len(t) == 5 and t[0] == b and t[4] == s
            and t[1] in ways(kv) and t[2] in ways(g) and t[3] in ways(s)}


class _Made(TorchDispatchMode):
    """Every op's float32 tensor outputs: (device, shape)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.made.append((str(t.device), tuple(t.shape)))
        return out


def _tc() -> TrainConfig:
    return TrainConfig(agg=AggConfig(kind=AggKind.CL_SIA, q=1),
                       opt=OptConfig(name="adamw", lr=1e-3,
                                     weight_decay=0.01),
                       q_frac=0.05, agg_dtype="float32", ef_dtype="float32")


def _fake_phase1(cfg, s: int) -> list:
    """Phase 1 of the port's step on one fake device a rank → the float32
    tensors it made, (device, shape)."""
    mesh = dryrun.rank_mesh(make_mesh(MESH, ("data", "model"),
                                      ["cpu"] * math.prod(MESH)))
    tc = _tc()
    step = build_train_step(cfg, tc, mesh)
    assert step.phase1_form({"tokens": torch.zeros((BATCH, s))}) == \
        "tensor_parallel"
    live, rec = dryrun.LiveBytes(), _Made()
    with dryrun._own_schedules(), dryrun._as_kernels(live), \
            FakeTensorMode(allow_non_fake_inputs=True), live:
        state = init_state(cfg, tc, mesh, None)
        toks = torch.zeros((BATCH, s), dtype=torch.int64,
                           device=mesh.devices[0])
        with rec:
            step.phase1(state, {"tokens": toks, "labels": toks})
    return rec.made


@pytest.mark.parametrize("name", list(PLACEMENT))
def test_each_rank_makes_the_references_score_tensor(reference, name):
    heads, kv, s, want, on = PLACEMENT[name]
    m = MESH[1]
    got = _fake_phase1(ModelConfig(**_tiny(heads, kv)), s)
    compiled = reference[0].result()[name]
    # the reference's per-device score tensor is the expected one
    assert _scores(compiled, heads, kv, s) == {want}, sorted(compiled)
    for r in range(math.prod(MESH)):
        mine = _scores({shape for dev, shape in got if dev == f"cpu:{r}"},
                       heads, kv, s)
        assert mine == ({want} if r % m in on else set()), (name, r, mine)


@pytest.mark.parametrize("name", STEP_CASES)
def test_the_step_equals_the_reference(reference, name):
    _, fut, inp = reference
    out = fut.result()
    c = _step_case(name)
    cfg, tc = ModelConfig(**c["tiny"]), _tc()
    mesh = make_mesh(MESH, ("data", "model"), ["cpu"] * math.prod(MESH))
    step = build_train_step(cfg, tc, mesh)
    s = PLACEMENT[name][2]
    assert query_blocks(MESH[1], cfg.num_heads, s, 8192) == (
        MESH[1] if s % MESH[1] == 0 else 1)
    prev = f"{name}/init/"
    st, m = step(ref_state(out, prev), batch_of(inp, name, 0))
    np.testing.assert_allclose(m["loss"].numpy(),
                               out[f"{name}/0/metrics/loss"], rtol=1e-5)
    got = port_leaves(st)
    want = {k: out[f"{name}/0/state/{k}"] for k in got}
    assert_same_support(got[".ef"], want[".ef"], name)
    old = {k: out[prev + k] for k in got}
    assert_step_close(name, old, got, want, 1e-3,
                      loose_coordinates(step, old, got, want),
                      3 * tc.opt.lr * float(m["lr_scale"].max()))


# (q heads, M, S, blocked threshold) → query blocks
RULE = {
    (6, 4, 32, 8192): 4,          # neither head dim divides: split
    (6, 4, 30, 8192): 1,          # S % M: whole
    (6, 4, 8192, 8192): 1,        # the blocked path: whole
    (24, 16, 4096, 8192): 16,     # phi4 on train_4k's 16 × 16
    (40, 16, 4096, 8192): 16,     # llama4-scout
    (24, 6, 4096, 8192): 1,       # the q heads divide: split by heads
    (32, 16, 4096, 8192): 1,
    (6, 1, 32, 8192): 1,          # one rank
}


@pytest.mark.parametrize("args", list(RULE))
def test_the_rule_of_query_blocks(args):
    heads, m, s, threshold = args
    assert query_blocks(m, heads, s, threshold) == RULE[args]


def test_the_split_lowers_rank_0s_peak(monkeypatch):
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    mesh = dryrun.rank_mesh(make_mesh(MESH, ("data", "model"),
                                      ["cpu"] * math.prod(MESH)))
    shape = ShapeSpec("seq_parallel", 512, BATCH, "train")
    tc = dryrun.default_train_config()
    split = dryrun.dry_run_cell(cfg, shape, mesh, tc)
    monkeypatch.setattr(attention, "query_blocks", lambda *a: 1)
    whole = dryrun.dry_run_cell(cfg, shape, mesh, tc)
    assert split["rank_peak_device"] == whole["rank_peak_device"] == "cpu:0"
    # one client's f32 scores: [b, heads, S, S]
    scores = BATCH // MESH[0] * cfg.num_heads * 512 ** 2 * 4
    assert split["rank_peak_bytes"] <= whole["rank_peak_bytes"] - scores, (
        split["rank_peak_bytes"], whole["rank_peak_bytes"], scores)
