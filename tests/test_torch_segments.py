"""The port's rotated-segment lowering (``run_plan_segments_local``,
``run_plan_segments_batched``, ``rotated_ring_local``, ``segment_budget``)
against the JAX package and against the port's own host executor.

The reference runs its segments kernel inside ``shard_map`` on 8 fake host
devices (``tests/test_device_plan.py``, ``SEGMENTS_EQUIV``;
``test_ring_shardmap.py``, ``RING_EQUIV``; ``test_wire_quant.py``,
``WIRE``). Here one subprocess (``conftest.run_multidev``) runs every case
of the reference under ``jax.jit`` + ``shard_map`` with
``kernel_mode="ref"`` on inputs made with numpy from a seed and written to
an ``.npz``, and writes the per-rank outputs to another; the port runs the
same cases in-process on ``client_mesh(8, devices=["cpu"] * 8)``:

* against the reference: the final segments, EF rows and the per-rank
  ``bits`` and ``nnz`` bit for bit, ``err_sq`` (a row sum in XLA's order)
  to rtol 1e-6;
* against the port's host ``execute`` per segment, with the rotation
  relabelling of ``SEGMENTS_EQUIV`` (position k of segment s is rank
  (k + s) mod K; stubs, budgets and stragglers are physical-rank
  properties): every output bit for bit, ``err_sq`` included;
* static transport equals the butterfly.

Sizes: K = 8 ranks; n = 8 · 48 (segments), 8 · 64 (ring and wire).
"""

import dataclasses
import functools
import json
import zlib

import numpy as np
import pytest
import torch

from repro_torch.agg import compile_plan, execute
from repro_torch.agg.device import (client_mesh, ring_chain_plan,
                                    run_plan_segments_batched,
                                    run_plan_segments_local)
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.core.ring import (RingStats, ring_hops, rotated_ring_local,
                                   segment_budget)
from repro_torch.topo.tree import PS, AggTree

torch.set_num_threads(1)

K = 8
N_SEG, N_RING = K * 48, K * 64
B = 3
PARENT = (-1, 0, 1, 1, 3, 0, 5, 2)          # -1: the PS
ORDER = [3, 1, 0, 6, 4, 2, 5, 7]
ALIVE = [1, 1, 1, 1, 1, 0, 1, 1]
QB = [5, 3, 5, 2, 5, 1, 4, 5]
PART = [1, 0, 1, 1, 1, 1, 0, 1]
ERR_RTOL = 1e-6
MESH = client_mesh(K, devices=["cpu"] * K)
KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia", "dense_ia"]


def _case(name, fn="segments", topo="tree", kind="cl_sia", q=5, w=1.3,
          n=N_SEG, gm=False, part=False, stub=False, b=0, cfg=None):
    return dict(name=name, fn=fn, topo=topo, kind=kind, q=q, w=w, n=n,
                gm=gm, part=part, stub=stub, b=b, cfg=cfg or {})


CASES = (
    [_case(f"tree/{k}", kind=k, gm=k in ("tc_sia", "cl_tc_sia"))
     for k in KINDS]
    + [_case(f"perm/{k}", topo="perm", kind=k,
             gm=k in ("tc_sia", "cl_tc_sia"))
       for k in ("cl_sia", "sia", "cl_tc_sia")]
    + [_case(f"stub/{k}", kind=k, stub=True, part=True)
       for k in ("cl_sia", "sia")]
    + [_case("threshold/tc_sia scan", kind="tc_sia", gm=True, part=True,
             cfg=dict(topq_impl="threshold")),
       _case("threshold/cl_sia hist", topo="perm", part=True,
             cfg=dict(topq_impl="threshold", tau_impl="hist",
                      hist_rounds=2)),
       _case("batched/tree cl_tc_sia", kind="cl_tc_sia", gm=True, part=True,
             b=B),
       _case("batched/chain sia", topo="chain", kind="sia", part=True, b=B)]
    + [_case(f"ring/{k}", fn="ring", topo="chain", kind=k, n=N_RING)
       for k in ("cl_sia", "sia", "re_sia", "dense_ia")]
    + [_case("wire/float32", fn="ring", topo="chain", w=1.0, n=N_RING,
             cfg=dict(wire_dtype="float32", omega=32)),
       _case("wire/bfloat16", fn="ring", topo="chain", w=1.0, n=N_RING,
             cfg=dict(wire_dtype="bfloat16", omega=16))])
BY_NAME = {c["name"]: c for c in CASES}


REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.agg import compile_plan
from repro.agg.device import run_plan_segments_batched, run_plan_segments_local
from repro.core import ring as ring_mod
from repro.core.algorithms import AggConfig, AggKind
from repro.topo.tree import AggTree, PS

inp = dict(np.load(INPUTS))
K = 8
mesh = compat.make_mesh((K,), ("data",))
out = {}
for c in json.loads(CASES):
    topo = (AggTree(parent=tuple(PS if p < 0 else p for p in PARENT))
            if c["topo"] == "tree" else
            np.asarray(ORDER, np.int32) if c["topo"] == "perm" else K)
    plan = compile_plan(topo)
    if c["stub"]:
        plan = dataclasses.replace(plan, alive=np.asarray(ALIVE, np.float32),
                                   q_budget=np.asarray(QB, np.int32))
    cfg = AggConfig(kind=AggKind(c["kind"]), q=c["q"], kernel_mode="ref",
                    **c["cfg"])
    name, b = c["name"], c["b"]
    g, e = inp[name + "/g"], inp[name + "/e"]
    gm = inp[name + "/gm"] if c["gm"] else np.zeros_like(g)
    part = inp[name + "/part"] if c["part"] else np.ones(g.shape[:-1],
                                                         np.float32)
    w = jnp.float32(c["w"])
    if b:
        def body(g_l, e_l, m_l, p_l):
            fin, ef, st = run_plan_segments_batched(
                cfg, plan, g_l[:, 0], e_l[:, 0], jnp.full((b,), w),
                axis="data",
                global_mask_local=m_l[:, 0] if c["gm"] else None,
                participate=p_l[:, 0] if c["part"] else None,
                transport="static")
            return (fin[:, None], ef[:, None],
                    jax.tree.map(lambda s: s[:, None], st))
        spec = P(None, "data")
    else:
        def body(g_l, e_l, m_l, p_l):
            kw = dict(global_mask_local=m_l[0] if c["gm"] else None,
                      participate=p_l[0] if c["part"] else None)
            if c["fn"] == "ring":
                fin, ef, st = ring_mod.rotated_ring_local(
                    cfg, g_l[0], e_l[0], w, axis="data", **kw)
            else:
                fin, ef, st = run_plan_segments_local(
                    cfg, plan, g_l[0], e_l[0], w, axis="data",
                    transport="static", **kw)
            return fin[None], ef[None], jax.tree.map(lambda s: s[None], st)
        spec = P("data")
    fn = jax.jit(compat.shard_map(
        body, mesh=mesh, in_specs=(spec,) * 4,
        out_specs=(spec, spec, jax.tree.map(
            lambda _: spec, ring_mod.RingStats(0., 0., 0.))),
        axis_names={"data"}))
    fin, ef, st = fn(g, e, gm, part)
    out[name + "/final"] = np.asarray(fin)
    out[name + "/ef"] = np.asarray(ef)
    for f in ("bits", "nnz", "err_sq"):
        out[name + "/" + f] = np.asarray(getattr(st, f))
np.savez(OUTPUTS, **out)
print("PASS")
"""


def _inputs(c) -> dict:
    """The case's numpy inputs: [K, n] rows (a cohort axis first when
    batched), a shared TCS mask per rank, participation per rank."""
    r = np.random.default_rng(zlib.crc32(c["name"].encode()))
    lead = (c["b"], K) if c["b"] else (K,)
    n = c["n"]
    g = r.standard_normal(lead + (n,)).astype(np.float32)
    e = (0.1 * r.standard_normal(lead + (n,))).astype(np.float32)
    if c["name"].startswith("wire/"):
        r = np.random.default_rng(7)
        g = r.standard_normal(lead + (n,)).astype(np.float32)
        e = np.zeros_like(g)
    out = {"g": g, "e": e}
    if c["gm"]:
        gm = np.zeros((n,), np.float32)
        gm[::50 if n == N_SEG else 17] = 1.0
        out["gm"] = np.broadcast_to(gm, lead + (n,)).copy()
    if c["part"]:
        p = np.asarray(PART, np.float32)
        if c["b"]:
            p = np.stack([np.roll(p, i) for i in range(c["b"])])
        out["part"] = p
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory, multidev):
    """Every case through the reference, in one 8-device subprocess."""
    d = tmp_path_factory.mktemp("segments")
    arrays = {}
    for c in CASES:
        for k, v in _inputs(c).items():
            arrays[f"{c['name']}/{k}"] = v
    np.savez(d / "in.npz", **arrays)
    script = (f"INPUTS = {str(d / 'in.npz')!r}\n"
              f"OUTPUTS = {str(d / 'out.npz')!r}\n"
              f"CASES = {json.dumps(CASES)!r}\n"
              f"PARENT, ORDER = {list(PARENT)!r}, {ORDER!r}\n"
              f"ALIVE, QB = {ALIVE!r}, {QB!r}\n" + REFERENCE)
    multidev(script, devices=K)
    return dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plan(c):
    topo = (AggTree(parent=tuple(PS if p < 0 else p for p in PARENT))
            if c["topo"] == "tree" else
            np.asarray(ORDER) if c["topo"] == "perm" else K)
    plan = compile_plan(topo)
    if c["stub"]:
        plan = dataclasses.replace(plan, alive=np.asarray(ALIVE, np.float32),
                                   q_budget=np.asarray(QB, np.int32))
    return plan


def _cfg(c) -> AggConfig:
    return AggConfig(kind=AggKind(c["kind"]), q=c["q"], **c["cfg"])


def _rows(x) -> list:
    return list(_t(x).unbind(-2)) if x is not None else None


def _run(c, transport="static"):
    """The port on the CPU mesh → (final [.., K, seg], EF [.., K, n], stats
    per field [.., K]) as numpy, ranks on the axis before the last."""
    x = _inputs(c)
    cfg = _cfg(c)
    gm = x.get("gm")
    part = x.get("part")
    if c["b"]:
        per_rank = lambda a: list(_t(a).transpose(0, 1))  # noqa: E731
        fin, ef, st = run_plan_segments_batched(
            cfg, _plan(c), MESH, per_rank(x["g"]), per_rank(x["e"]), c["w"],
            global_mask=None if gm is None else per_rank(gm),
            participate=(None if part is None
                         else list(_t(part).transpose(0, 1))),
            transport=transport)
        stack = lambda xs: torch.stack(xs, 1).numpy()  # noqa: E731
    else:
        kw = dict(global_mask=None if gm is None else list(_t(gm)),
                  participate=None if part is None else list(_t(part)))
        if c["fn"] == "ring":
            fin, ef, st = rotated_ring_local(cfg, MESH, list(_t(x["g"])),
                                             list(_t(x["e"])), c["w"], **kw)
        else:
            fin, ef, st = run_plan_segments_local(
                cfg, _plan(c), MESH, list(_t(x["g"])), list(_t(x["e"])),
                c["w"], transport=transport, **kw)
        stack = lambda xs: torch.stack(xs).numpy()  # noqa: E731
    return (stack(fin), stack(ef),
            {f: stack([getattr(s, f) for s in st])
             for f in ("bits", "nnz", "err_sq")})


def _bits_equal(a, b, msg):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.shape,
                                                        b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _port(name, transport="static"):
    return _run(BY_NAME[name], transport)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_segments_match_the_reference(reference, name):
    fin, ef, st = _port(name)
    _bits_equal(reference[name + "/final"], fin, name + " final")
    _bits_equal(reference[name + "/ef"], ef, name + " ef")
    for f in ("bits", "nnz"):
        _bits_equal(reference[name + "/" + f], st[f], name + " " + f)
    np.testing.assert_allclose(st["err_sq"], reference[name + "/err_sq"],
                               rtol=ERR_RTOL, err_msg=name + " err_sq")


def test_bf16_wire_quantization(reference):
    """The reference's ``WIRE`` test on the port's ring: a bf16 wire (ω =
    16) stays within 2e-2 of the float32 wire on the same support, and
    halves the ω bits; the compact wire carries bf16 values under
    ``wire="auto"``."""
    f32, _, st32 = _port("wire/float32")
    bf, _, st16 = _port("wire/bfloat16")
    rel = np.max(np.abs(f32 - bf) / np.maximum(np.abs(f32), 1e-3))
    assert 0 < rel < 2e-2, rel
    np.testing.assert_array_equal(f32 != 0, bf != 0)
    assert st16["bits"].sum() < 0.7 * st32["bits"].sum()


# ---------------------------------------------------------------------------
# against the port's host execute, per rotated segment
# ---------------------------------------------------------------------------

def _host_segments(c, cfg, plan, g, e, gm, part):
    """Host ``execute`` per segment s on an all-alive plan whose position k
    is rank (k + s) mod K, with participation·alive and budgets
    relabelled: → (aggregates [K, seg], EF [K, n], per-segment results)."""
    n = g.shape[-1]
    seg = n // K
    alive = np.asarray(plan.alive, np.float32)
    p_rank = alive * (np.ones(K, np.float32) if part is None else part)
    base = dataclasses.replace(plan, alive=np.ones(K, np.float32),
                               q_budget=None)
    aggs, ef, res = [], np.zeros_like(e), []
    for s in range(K):
        rot = [(k + s) % K for k in range(K)]
        p_s = dataclasses.replace(
            base, q_budget=(None if plan.q_budget is None
                            else np.asarray(plan.q_budget)[rot]))
        cols = slice(s * seg, (s + 1) * seg)
        r = execute(cfg, p_s, _t(g[rot, cols]), _t(e[rot, cols]),
                    torch.full((K,), c["w"]),
                    global_mask=None if gm is None else _t(gm[cols]),
                    participate=_t(p_rank[rot]))
        aggs.append(r.aggregate.numpy())
        for k in range(K):
            ef[rot[k], cols] = r.e_new[k].numpy()
        res.append(r)
    return np.stack(aggs), ef, res


def _pairwise_sum(v):
    """Σ over the last axis: the columns' halves added pairwise until one
    column is left, an odd last column carried to the next pass."""
    cols = list(v.unbind(-1))
    while len(cols) > 1:
        h = len(cols) // 2
        cols = [cols[i] + cols[h + i] for i in range(h)] + cols[2 * h:]
    return cols[0]


def _rank_stats(plan, res, register: bool) -> dict:
    """Each rank's stats summed as the lowering sums them: level by level,
    its lanes (slot w plays position node_id[l, w] of segment (r − node)
    mod K) masked by the slots and summed per level in the lowering's
    fixed pairwise order."""
    node = np.asarray(plan.node_id)
    real = np.asarray(plan.slot_mask) > 0
    mask = torch.from_numpy(np.asarray(plan.slot_mask, np.float32))
    out = {}
    for f, field in (("bits", "bits"), ("nnz", "nnz_out"),
                     ("err_sq", "err_sq")):
        acc = torch.zeros(K)
        for li in range(node.shape[0]):
            v = torch.zeros((K, node.shape[1]))
            for r in range(K):
                for wi in np.flatnonzero(real[li]):
                    b = int(node[li, wi])
                    v[r, wi] = getattr(res[(r - b) % K].stats,
                                       field)[b].to(torch.float32)
            acc = acc + (v[:, 0] if register
                         else _pairwise_sum(v * mask[li][None]))
        out[f] = acc.numpy()
    return out


HOST = [c["name"] for c in CASES if c["fn"] == "segments" and not c["b"]]


@pytest.mark.parametrize("name", HOST)
def test_segments_equal_host_execute_per_segment(name):
    c = BY_NAME[name]
    x = _inputs(c)
    cfg, plan = _cfg(c), _plan(c)
    part = x.get("part")
    aggs, ef, res = _host_segments(c, cfg, plan, x["g"], x["e"],
                                   None if "gm" not in x else x["gm"][0],
                                   part)
    fin, got_ef, st = _port(name)
    _bits_equal(aggs, fin, name + " final")
    _bits_equal(ef, got_ef, name + " ef")
    register = c["topo"] != "tree"
    want = _rank_stats(plan, res, register)
    for f in ("bits", "nnz", "err_sq"):
        _bits_equal(want[f], st[f], name + " " + f)


@pytest.mark.parametrize("name", ["batched/tree cl_tc_sia",
                                  "batched/chain sia"])
def test_batched_segments_equal_each_cohort_alone(name):
    """Each cohort of a batched round is the sequential lowering's round on
    that cohort, bit for bit (and its butterfly equals its static run)."""
    c = BY_NAME[name]
    x = _inputs(c)
    fin, ef, st = _port(name)
    for b in range(c["b"]):
        one = dict(c, b=0)
        cfg = _cfg(one)
        got = run_plan_segments_local(
            cfg, _plan(one), MESH, list(_t(x["g"][b])), list(_t(x["e"][b])),
            c["w"], global_mask=(None if "gm" not in x
                                 else list(_t(x["gm"][b]))),
            participate=None if "part" not in x else list(_t(x["part"][b])))
        _bits_equal(torch.stack(got[0]).numpy(), fin[b], f"{name} {b}")
        _bits_equal(torch.stack(got[1]).numpy(), ef[b], f"{name} {b} ef")
        for f in ("bits", "nnz", "err_sq"):
            _bits_equal(torch.stack([getattr(s, f) for s in got[2]]).numpy(),
                        st[f][b], f"{name} {b} {f}")
    bf = _port(name, "butterfly")
    _bits_equal(fin, bf[0], name + " butterfly")
    _bits_equal(ef, bf[1], name + " butterfly ef")


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if c["fn"] == "segments" and not c["b"]])
def test_static_transport_equals_the_butterfly(name):
    fin, ef, st = _port(name)
    bf, bf_ef, bst = _port(name, "butterfly")
    _bits_equal(fin, bf, name)
    _bits_equal(ef, bf_ef, name + " ef")
    for f in ("bits", "nnz", "err_sq"):
        _bits_equal(st[f], bst[f], name + " " + f)


@pytest.mark.parametrize("kind", ["cl_sia", "sia", "re_sia", "dense_ia"])
def test_ring_equals_host_execute_on_the_ring_chain(kind):
    """``rotated_ring_local`` is the ring chain plan per segment: segment s
    visits ranks s, s+1, …, s+K−1 and ends at rank s."""
    c = BY_NAME["ring/" + kind]
    x = _inputs(c)
    aggs, ef, res = _host_segments(c, _cfg(c), ring_chain_plan(K), x["g"],
                                   x["e"], None, None)
    fin, got_ef, st = _port(c["name"])
    _bits_equal(aggs, fin, kind)
    _bits_equal(ef, got_ef, kind + " ef")
    want = _rank_stats(ring_chain_plan(K), res, True)
    for f in ("bits", "nnz", "err_sq"):
        _bits_equal(want[f], st[f], kind + " " + f)


def test_mixed_devices_and_tensor_weights_equal_the_plain_mesh():
    """A mesh whose ranks alternate between two devices (``cpu`` and
    ``cpu:0`` are two mesh devices, so rank blocks and every transfer take
    the multi-device path), per-rank weights given as tensors, and EF in
    bf16 storage."""
    c = BY_NAME["tree/cl_tc_sia"]
    x = _inputs(c)
    cfg = _cfg(c)
    w = [torch.tensor(1.3)] * K
    gm = list(_t(x["gm"]))
    want = run_plan_segments_local(cfg, _plan(c), MESH, list(_t(x["g"])),
                                   list(_t(x["e"])), w, global_mask=gm)
    odd = client_mesh(K, devices=["cpu:0" if r % 2 else "cpu"
                                  for r in range(K)])
    assert len(odd.distinct()) == 2
    got = run_plan_segments_local(cfg, _plan(c), odd, list(_t(x["g"])),
                                  list(_t(x["e"])), 1.3, global_mask=gm)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        _bits_equal(a.numpy(), b.numpy(), "mesh")
    e16 = [t.to(torch.bfloat16) for t in _t(x["e"])]
    got16 = run_plan_segments_local(cfg, _plan(c), MESH, list(_t(x["g"])),
                                    e16, w, global_mask=gm)
    assert all(t.dtype == torch.bfloat16 for t in got16[1])
    host, host_ef, _ = _host_segments(
        c, cfg, _plan(c), x["g"],
        torch.stack(e16).to(torch.float32).numpy(), x["gm"][0], None)
    _bits_equal(host, torch.stack(got16[0]).numpy(), "bf16 EF storage")
    _bits_equal(torch.from_numpy(host_ef).to(torch.bfloat16)
                .view(torch.int16).numpy(),
                torch.stack(got16[1]).view(torch.int16).numpy(),
                "bf16 EF rows")


def test_segment_budget_and_ring_hops():
    assert segment_budget(78 * 28, 28) == 78
    assert segment_budget(100, 8) == 12
    assert 8 * segment_budget(100, 8) <= 100
    assert segment_budget(5, 8) == 0           # no K-fold inflation
    assert segment_budget(-3, 4) == 0
    with pytest.raises(ValueError, match="positive"):
        segment_budget(10, 0)
    assert ring_hops(28) == 28
    assert RingStats._fields == ("bits", "nnz", "err_sq")


def test_segments_errors():
    cfg = AggConfig(q=3)
    g = [torch.zeros(N_SEG)] * K
    plan = compile_plan(K)
    with pytest.raises(ValueError, match="clients but the mesh has"):
        run_plan_segments_local(cfg, compile_plan(4), MESH, g, g, 1.0)
    with pytest.raises(ValueError, match="unknown transport"):
        run_plan_segments_local(cfg, plan, MESH, g, g, 1.0,
                                transport="ring")
    with pytest.raises(ValueError, match="multiple"):
        run_plan_segments_local(cfg, plan, MESH, [torch.zeros(N_SEG + 1)] * K,
                                [torch.zeros(N_SEG + 1)] * K, 1.0)
    with pytest.raises(ValueError, match="unknown wire"):
        run_plan_segments_local(cfg, plan, MESH, g, g, 1.0, wire="sparse")
    forest = dataclasses.replace(plan, num_sinks=2)
    with pytest.raises(ValueError, match="run_nested_segments_local"):
        run_plan_segments_local(cfg, forest, MESH, g, g, 1.0)
    traced = dataclasses.replace(plan, node_id=torch.as_tensor(plan.node_id))
    with pytest.raises(ValueError, match="transport='static'"):
        run_plan_segments_local(cfg, traced, MESH, g, g, 1.0,
                                transport="static")
    stacked = dataclasses.replace(plan, node_id=np.stack([plan.node_id] * 2))
    with pytest.raises(ValueError, match="one shared plan"):
        run_plan_segments_batched(cfg, stacked, MESH,
                                  [torch.zeros((2, N_SEG))] * K,
                                  [torch.zeros((2, N_SEG))] * K, 1.0)
    with pytest.raises(ValueError, match="entries for 8 ranks"):
        run_plan_segments_local(cfg, plan, MESH, g[:3], g, 1.0)
