"""Shared helpers of the train-step parity tests
(``tests/test_torch_train_step.py``, ``test_torch_train_topologies.py``).

The reference's train step runs under ``jax.jit`` + ``shard_map`` on 8
fake host devices in a subprocess (``conftest.run_multidev``): each case
builds its mesh, ``init_state`` from ``PRNGKey(0)`` (or ``PRNGKey(0)``
split per cohort), and takes its steps on token batches made with numpy;
every state and every step's metrics go to an ``.npz`` under the
checkpoint key paths (``.params/layers/…``, ``.master``, ``.ef``, …). The
port starts from the reference's initial state
(:func:`repro_torch.convert.train_state`) and takes the same steps on
``["cpu"] * 8`` ranks.

A case with ``fake_grads`` replaces the reference's ``models.model.
loss_fn`` by ``Σ_leaves Σ p · G_k``, ``G_k`` riding in client k's slice
of the batch, whose gradient is ``G_k`` exactly: the reference's real step then
runs its phases 2–3 on given per-client gradients, and the port runs its
phase functions on the same ``G_k``.
"""

import json
import os
import subprocess
import sys
import tempfile
import types

import numpy as np
import torch

from conftest import SRC
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import _flatten_with_paths

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            head_dim=16, param_dtype="float32")
SMOKE_FAMILIES = {"dense": "codeqwen1.5-7b", "moe": "mixtral-8x7b",
                  "ssm": "mamba2-130m", "hybrid": "zamba2-1.2b"}

REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import get_config
from repro.configs.base import ModelConfig
from repro.core.algorithms import AggConfig, AggKind
from repro.launch.mesh import make_agg_plan
from repro.models import model as mm
from repro.optim.optimizers import OptConfig
from repro.topo import graph as tg
from repro.topo.tree import star_tree
from repro.train.state import TrainConfig
from repro.train import build_train_step, init_state, state_shardings

inp = dict(np.load(INPUTS))
out = {}
real_loss = mm.loss_fn


def topology(spec, mesh):
    if spec is None:
        return None
    if spec == "hierarchical":
        return make_agg_plan(mesh, "hierarchical")
    if spec[0] == "star":
        return make_agg_plan(mesh, star_tree(spec[1]))
    if spec[0] == "grid":
        return make_agg_plan(mesh, tg.grid_graph(*spec[1]))
    if spec[0] == "nested":
        from repro.agg import compile_nested
        return compile_nested(
            [[(tuple(mem), None if t is None else star_tree(len(mem)))
              for mem, t in stage] for stage in spec[1]],
            num_clients=spec[2])
    raise ValueError(spec)


def save(prefix, tree):
    for path, leaf in zip(*_flatten_with_paths(tree)[:2]):
        out[prefix + path] = np.asarray(leaf).astype(
            np.float32 if np.asarray(leaf).dtype.name == "bfloat16"
            else np.asarray(leaf).dtype)


for c in json.loads(CASES):
    name = c["name"]
    mesh = compat.make_mesh(tuple(c["mesh"]), tuple(c["axes"]))
    cfg = (dataclasses.replace(get_config(c["arch"], smoke=True),
                               param_dtype="float32", **c.get("over", {}))
           if "arch" in c else ModelConfig(**c["tiny"]))
    t = c["tc"]
    tc = TrainConfig(agg=AggConfig(kind=AggKind(t["kind"]), q=1,
                                   kernel_mode="ref"),
                     opt=OptConfig(**t["opt"]), q_frac=t["q_frac"],
                     agg_dtype="float32", ef_dtype="float32",
                     fsdp_compute=t.get("fsdp", False))
    topo = topology(c["topology"], mesh)
    coh = c["cohorts"]
    with compat.set_mesh(mesh):
        st = init_state(cfg, tc, mesh, jax.random.PRNGKey(0),
                        topology=topo, cohorts=coh)
        if c.get("tcs_delta"):
            leaves, tdef = jax.tree.flatten(st.params)
            paths = _flatten_with_paths(st.params)[0]
            st = st._replace(tcs_prev=jax.tree.unflatten(tdef, [
                l - inp[f"{name}/delta/{p}"] for l, p in zip(leaves, paths)]))
        save(f"{name}/init/", st)
        st = jax.device_put(st, state_shardings(cfg, tc, mesh, topology=topo,
                                                cohorts=coh))
        step = jax.jit(build_train_step(cfg, tc, mesh, topology=topo,
                                        cohorts=coh))
        paths = _flatten_with_paths(st.params)[0]

        def fake(cfg_, p, batch):
            # client k's batch slice holds its own G_k: d loss / d p = G_k
            tot = sum(jnp.sum(l * batch["G/" + q][0])
                      for l, q in zip(jax.tree.leaves(p), paths))
            return tot, {}
        if c.get("fake_grads"):
            mm.loss_fn = fake
        for i in range(c["steps"]):
            batch = {"tokens": jnp.asarray(inp[f"{name}/tokens/{i}"]),
                     "labels": jnp.asarray(inp[f"{name}/labels/{i}"])}
            if c.get("fake_grads"):
                for q in paths:
                    batch["G/" + q] = jnp.asarray(inp[f"{name}/G/{i}/{q}"])
            for key in ("participate", "frontend_embeds", "frontend_mask"):
                if f"{name}/{key}/{i}" in inp:
                    batch[key] = jnp.asarray(inp[f"{name}/{key}/{i}"])
            st, m = step(st, batch)
            save(f"{name}/{i}/state/", st)
            for k, v in m.items():
                out[f"{name}/{i}/metrics/{k}"] = np.asarray(v)
        if c.get("ckpt"):
            from repro.checkpoint import save as save_checkpoint
            save_checkpoint(c["ckpt"], c["steps"], st)
    mm.loss_fn = real_loss
    print(name, "done", flush=True)
np.savez(OUTPUTS, **out)
print("PASS")
"""


def run_reference(cases: list, inputs: dict, timeout: int = 600) -> dict:
    """Run the reference on ``cases`` with ``inputs`` in an 8-device
    subprocess; → its outputs (see the module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(fin, **inputs)
        script = (f"INPUTS = {fin!r}\nOUTPUTS = {fout!r}\n"
                  f"CASES = {json.dumps(json.dumps(cases))}\n" + REFERENCE)
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0 or "PASS" not in proc.stdout:
            raise AssertionError(
                f"reference subprocess failed\nSTDOUT:\n"
                f"{proc.stdout[-4000:]}\nSTDERR:\n{proc.stderr[-4000:]}")
        return dict(np.load(fout))


def start_reference(cases: list, inputs: dict):
    """:func:`run_reference` in a background thread; ``.result()`` waits."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(run_reference, cases, inputs)
    pool.shutdown(wait=False)
    return fut


def case(name, *, mesh=(4, 2), axes=("data", "model"), arch=None,
         kind="cl_sia", opt=None, topology=None, cohorts=1, steps=2,
         fake_grads=False, tcs_delta=False, over=None, fsdp=False) -> dict:
    """One reference case (the tiny dense model unless ``arch``; ``over``
    replaces fields of the arch's SMOKE config), q_frac 0.05, f32
    storage, ``fsdp_compute=fsdp``."""
    c = dict(name=name, mesh=list(mesh), axes=list(axes),
             tc=dict(kind=kind, opt=opt or dict(name="adamw", lr=1e-3,
                                                weight_decay=0.01),
                     q_frac=0.05, fsdp=fsdp),
             topology=topology, cohorts=cohorts, steps=steps,
             fake_grads=fake_grads, tcs_delta=tcs_delta)
    if arch is None:
        c["tiny"] = TINY
    else:
        c["arch"] = arch
    if over:
        c["over"] = over
    return c


def port_topology(spec, mesh):
    """The port's counterpart of the reference script's ``topology``."""
    from repro_torch.agg import compile_nested
    from repro_torch.launch.mesh import make_agg_plan
    from repro_torch.topo import graph as tg
    from repro_torch.topo.tree import star_tree
    if spec is None:
        return None
    if spec == "hierarchical":
        return make_agg_plan(mesh, "hierarchical")
    if spec[0] == "star":
        return make_agg_plan(mesh, star_tree(spec[1]))
    if spec[0] == "grid":
        return make_agg_plan(mesh, tg.grid_graph(*spec[1]))
    if spec[0] == "nested":
        return compile_nested(
            [[(tuple(mem), None if t is None else star_tree(len(mem)))
              for mem, t in stage] for stage in spec[1]],
            num_clients=spec[2])
    raise ValueError(spec)


def tokens(seed: int, vocab: int, shape=(8, 16)) -> tuple:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    return toks, np.roll(toks, -1, axis=-1)


def tree_of(out: dict, prefix: str):
    """The nested dict under ``prefix`` (``.params`` → {layers: …})."""
    tree: dict = {}
    for key, v in out.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree or None


def ref_state(out: dict, prefix: str, device="cpu"):
    """The reference's saved state under ``prefix`` → the port's
    TrainState (parameters f32 as saved)."""
    get = out.get
    stage = tree_of(out, prefix + ".stage_ef")
    ns = types.SimpleNamespace(
        step=get(prefix + ".step"), params=tree_of(out, prefix + ".params"),
        master=get(prefix + ".master"),
        opt=types.SimpleNamespace(step=get(prefix + ".opt/.step"),
                                  m=get(prefix + ".opt/.m"),
                                  v=get(prefix + ".opt/.v")),
        ef=get(prefix + ".ef"), tcs_prev=tree_of(out, prefix + ".tcs_prev"),
        stage_ef=None if stage is None else tuple(
            stage[str(i)] for i in range(len(stage))))
    return convert.train_state(ns, device)


def port_leaves(state) -> dict:
    """The port state's leaves by checkpoint key path, as numpy."""
    out = {}
    for parts, leaf in _flatten_with_paths(state):
        x = leaf.detach().cpu()
        out["/".join(parts)] = (x.float() if x.dtype == torch.bfloat16
                                else x).numpy()
    return out


def bits(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def batch_of(inputs: dict, name: str, i: int, device="cpu") -> dict:
    b = {"tokens": torch.as_tensor(inputs[f"{name}/tokens/{i}"]).long(),
         "labels": torch.as_tensor(inputs[f"{name}/labels/{i}"]).long()}
    for key in ("participate", "frontend_embeds", "frontend_mask"):
        if f"{name}/{key}/{i}" in inputs:
            b[key] = torch.as_tensor(inputs[f"{name}/{key}/{i}"])
    return {k: v.to(device) for k, v in b.items()}


def _pair_gap(a: np.ndarray, b: np.ndarray) -> float:
    """The largest relative gap between two sets of swapped magnitudes,
    sorted and paired (``inf`` where their counts differ)."""
    if a.size != b.size:
        return np.inf
    if not a.size:
        return 0.0
    a, b = np.sort(a), np.sort(b)
    return np.abs(a - b).max() / max(a.max(), 1e-30)


def assert_same_support(got, want, what, cascade: bool = False):
    """The transmitted support (``ef == 0``) is equal, or differs only by
    swaps at a tie: per EF row, as many coordinates kept by the port alone
    as by the reference alone, the magnitudes each side left in its EF
    there equal to rtol 1e-5 (two candidates tied at the Q-th magnitude).
    Anything else fails, with the gap between the swapped magnitudes.

    With ``cascade`` (a chain, whose rows follow one another), a swap
    reaches the later rows: a coordinate sent on one side only arrives in
    the next client's γ_in on that side alone, enters its Top-Q there and
    displaces the smallest coordinate that the other side keeps. A row
    whose swaps involve coordinates already swapped above also passes,
    but only where its counts match, each arrived coordinate accounts for
    one displaced coordinate on the other side (the smallest it kept
    alone), and the swaps left over still meet the 1e-5 gap."""
    rows = {}
    for k in range(got.shape[0]):
        only_port = np.nonzero((got[k] == 0) & (want[k] != 0))[0]
        only_ref = np.nonzero((want[k] == 0) & (got[k] != 0))[0]
        if only_port.size or only_ref.size:
            rows[k] = (only_port, only_ref)
    swapped: set = set()
    for k, (only_port, only_ref) in rows.items():
        n, m = only_port.size, only_ref.size
        # the magnitudes each side left in its EF where the other sent
        a, b = np.abs(want[k, only_port]), np.abs(got[k, only_ref])
        gap = _pair_gap(a, b)
        if cascade and n == m and gap > 1e-5:
            came_p = np.isin(only_port, list(swapped))
            came_r = np.isin(only_ref, list(swapped))
            # each arrival displaced the other side's smallest keep
            left_b = np.sort(b[~came_r])[int(came_p.sum()):]
            left_a = np.sort(a[~came_p])[int(came_r.sum()):]
            if came_p.any() or came_r.any():
                gap = _pair_gap(left_a, left_b)
        assert n == m and gap <= 1e-5, (
            f"{what}: row {k}: {n} coordinates kept by the port alone, {m} "
            f"by the reference alone; relative gap between the swapped "
            f"magnitudes {gap:.3e}")
        swapped.update(only_port.tolist(), only_ref.tolist())


def loose_coordinates(step, old: dict, got: dict, want: dict) -> dict:
    """Where the step's update may rightly differ from the reference's by
    up to a step, as bool arrays under ``.master`` and each ``.params/…``
    key (flat coordinates mapped through the step's downlink); ``old``,
    ``got`` and ``want`` are states by key path:

    * a support swap at a tie (see ``_assert_same_support`` of
      ``test_torch_train_step.py``): the transmitted support (``ef == 0``)
      differs in some client's EF row, or, under AdamW, the aggregate's
      support differs (the first moment left its decay ``b1·m`` on one
      side only: a tie swapped at any stage of the plan);
    * under AdamW, ``0 < √v̂ < 1e3·eps`` in the reference's new second
      moment: there the update ``m̂ / (√v̂ + eps)`` turns a last-bit
      difference of a gradient near zero into a change of its own size.
    """
    flat = ((got[".ef"] == 0) != (want[".ef"] == 0)).any(axis=-2)
    opt = step.tc.opt
    if opt.name == "adamw":
        decayed = old[".opt/.m"] * np.float32(opt.b1)
        flat = flat | ((got[".opt/.m"] != decayed)
                       != (want[".opt/.m"] != decayed))
        t = np.asarray(want[".opt/.step"], np.float64)[..., None]
        v = want[".opt/.v"].astype(np.float64)
        root = np.sqrt(v / (1 - opt.b2 ** t))
        flat = flat | ((v > 0) & (root < 1e3 * opt.eps))
    mask = torch.from_numpy(flat.astype(np.float32))
    trees = [step.downlink(row) for row in mask.reshape(-1, mask.shape[-1])]
    out = {".master": flat}
    for i, (parts, _) in enumerate(_flatten_with_paths(trees[0])):
        leaves = [_flatten_with_paths(t)[i][1] for t in trees]
        leaf = leaves[0] if flat.ndim == 1 else torch.stack(leaves)
        out["/".join((".params",) + parts)] = leaf.float().numpy() != 0
    return out


def step_change_error(old: np.ndarray, got: np.ndarray, want: np.ndarray,
                      loose=None, slack: float = 0.0) -> float:
    """How far one state leaf's change over a step (``got − old``) is
    from the reference's (``want − old``): the largest
    ``|Δgot − Δwant| / (|Δwant| + max |Δwant|)`` over the coordinates
    where that difference exceeds ``2·eps_f32·|want|`` (the roundings of
    the two new values) and, at ``loose`` coordinates
    (:func:`loose_coordinates`), ``slack``.
    A missing update or one of the wrong sign gives about 1 or more."""
    old = old.astype(np.float64)
    d_got = got.astype(np.float64) - old
    d_want = want.astype(np.float64) - old
    err = np.abs(d_got - d_want)
    free = 2 * float(np.finfo(np.float32).eps) * np.abs(want).astype(
        np.float64)
    if loose is not None:
        free = free + slack * loose
    scale = np.abs(d_want) + np.abs(d_want).max()
    over = err > free
    if not over.any():
        return 0.0
    return float((err[over] / np.maximum(scale[over], 1e-300)).max())


def assert_step_close(what: str, old: dict, got: dict, want: dict,
                      rtol: float, loose=None, slack: float = 0.0):
    """:func:`step_change_error` ≤ ``rtol`` for every ``.master`` and
    ``.params/…`` leaf of ``got`` (dicts by checkpoint key path)."""
    for key in got:
        if not key.startswith((".master", ".params")):
            continue
        e = step_change_error(old[key], got[key], want[key],
                              None if loose is None else loose[key],
                              slack)
        assert e <= rtol, (f"{what} {key}: the step's change is off by "
                           f"{e:.3e} of its scale (limit {rtol})")
