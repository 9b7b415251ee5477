"""The port's nested rotated-segment lowering (``run_nested_segments_local``,
``hierarchical_ring_local``, ``dci_bytes_flat_vs_hier``,
``ClusteredStage.uniform``) against the JAX package and against staged
host ``execute``.

The reference runs on a (pod, data) mesh of 8 fake host devices
(``tests/test_nested_device.py``: ``SEGMENTS_CHAIN_EQUIV``,
``SEGMENTS_TREE_EQUIV``; ``tests/test_hierarchical.py``). One subprocess
runs every case of the reference under ``jax.jit`` + ``shard_map`` with
``kernel_mode="ref"`` on inputs made with numpy from a seed; the port runs
the same cases on ``client_mesh(8, devices=["cpu"] * 8)`` with axis sizes
``(K_data, K_pod) = (4, 2)`` (rank ``p·K_data + r`` is member r of pod p,
the reference's ``P(("pod", "data"))`` order):

* against the reference: final segments, both EF tiers and the per-rank,
  per-stage ``bits`` and ``nnz`` bit for bit, ``err_sq`` to rtol 1e-6;
* against the staged host reference of ``SEGMENTS_TREE_EQUIV`` (stage 0
  per data segment on the merged forest, stage 1 per pod sub-segment on
  the sink partials) bit for bit, for per-pod different trees (the
  butterfly) and identical trees (static transport, with stragglers);
* the chain×chain plan equals two composed rotated rings, and
  ``hierarchical_ring_local`` equals it; mass is conserved.
"""

import json
import zlib

import numpy as np
import pytest
import torch

from repro.agg import nested as jnested
from repro.core import hierarchical as jhier
from repro.topo.tree import PS as JPS
from repro.topo.tree import AggTree as JTree
from repro_torch.agg import compile_nested, execute, pod_ring_nested
from repro_torch.agg.device import client_mesh, run_nested_segments_local
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.core.hierarchical import (HierStats, dci_bytes_flat_vs_hier,
                                           hierarchical_ring_local)
from repro_torch.core.ring import rotated_ring_local
from repro_torch.topo.tree import PS, AggTree

torch.set_num_threads(1)

KP, KD = 2, 4
K = KP * KD
SIZES = (KD, KP)
MESH = client_mesh(K, devices=["cpu"] * K)
ERR_RTOL = 1e-6
PART = [1, 1, 0, 1, 1, 1, 1, 0]
# intra-pod trees, parent of each local member (-1: the pod's sink)
TREES = {"tree": ((1, 2, 3, -1), (3, 0, 0, -1)),
         "uniform": ((-1, 0, 0, 1), (-1, 0, 0, 1))}
INTER = (1, -1)


def _case(name, plan, kind, q, w, n, mask_step=None, part=False,
          fn="nested"):
    return dict(name=name, plan=plan, kind=kind, q=q, w=w, n=n,
                mask_step=mask_step, part=part, fn=fn)


CASES = (
    [_case(f"chain/{k}", "chain", k, 8, 1.3, KD * KP * 16,
           17 if k == "cl_tc_sia" else None)
     for k in ("cl_sia", "sia", "cl_tc_sia")]
    + [_case(f"hier/{k}", "chain", k, 8, 1.3, KD * KP * 16,
             17 if k == "cl_tc_sia" else None, fn="hier")
       for k in ("cl_sia", "sia", "cl_tc_sia")]
    + [_case(f"tree/{k}", "tree", k, 5, 1.1, KD * KP * 12,
             37 if k == "cl_tc_sia" else None)
       for k in ("cl_sia", "sia", "cl_tc_sia")]
    + [_case(f"uniform/{k}", "uniform", k, 5, 0.9, KD * KP * 12,
             29 if k == "cl_tc_sia" else None, part=True)
       for k in ("cl_tc_sia", "re_sia")]
    + [_case(f"mass/{k}", "chain", k, 4, 1.0, KD * KP * 16, fn="hier")
       for k in ("cl_sia", "dense_ia")])
BY_NAME = {c["name"]: c for c in CASES}


REFERENCE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.agg.device import run_nested_segments_local
from repro.agg.nested import compile_nested, pod_ring_nested
from repro.core.algorithms import AggConfig, AggKind
from repro.core.hierarchical import hierarchical_ring_local
from repro.core.ring import RingStats
from repro.topo.tree import AggTree, PS

inp = dict(np.load(INPUTS))
KP, KD = 2, 4
mesh = compat.make_mesh((KP, KD), ("pod", "data"))
tree = lambda par: AggTree(parent=tuple(PS if p < 0 else p for p in par))
out = {}
for c in json.loads(CASES):
    if c["plan"] == "chain":
        nested = pod_ring_nested(KP, KD)
    else:
        t0, t1 = TREES[c["plan"]]
        nested = compile_nested(
            [[(tuple(range(0, 4)), tree(t0)), (tuple(range(4, 8)), tree(t1))],
             [((0, 1), tree(INTER))]])
    cfg = AggConfig(kind=AggKind(c["kind"]), q=c["q"], kernel_mode="ref")
    name = c["name"]
    g, e, pe = inp[name + "/g"], inp[name + "/e"], inp[name + "/pe"]
    gm = (jnp.asarray(inp[name + "/gm"]) if c["mask_step"] is not None
          else None)
    part = inp[name + "/part"] if c["part"] else np.ones((8,), np.float32)
    w = jnp.float32(c["w"])

    def body(g_l, e_l, pe_l, p_l):
        p = p_l[0] if c["part"] else None
        if c["fn"] == "hier":
            s2, ef, pef, st = hierarchical_ring_local(
                cfg, g_l[0], e_l[0], pe_l[0], w, global_mask_local=gm,
                participate=p)
            st = (st.intra, st.inter)
        else:
            s2, ef, (pef,), st = run_nested_segments_local(
                cfg, nested, g_l[0], e_l[0], (pe_l[0],), w,
                axes=("data", "pod"), global_mask_local=gm, participate=p)
        return (s2[None], ef[None], pef[None],
                jax.tree.map(lambda s: s[None], st))

    spec = P(("pod", "data"))
    sspec = jax.tree.map(lambda _: spec, (RingStats(0., 0., 0.),) * 2)
    s2, ef, pef, st = jax.jit(compat.shard_map(
        body, mesh=mesh, in_specs=(spec,) * 4,
        out_specs=(spec, spec, spec, sspec),
        axis_names={"pod", "data"}))(g, e, pe, part)
    out[name + "/final"] = np.asarray(s2)
    out[name + "/ef"] = np.asarray(ef)
    out[name + "/pef"] = np.asarray(pef)
    for i, sti in enumerate(st):
        for f in ("bits", "nnz", "err_sq"):
            out[f"{name}/{i}/{f}"] = np.asarray(getattr(sti, f))
np.savez(OUTPUTS, **out)
print("PASS")
"""


def _inputs(c) -> dict:
    """The case's numpy inputs; a ``hier/`` case takes its ``chain/``
    twin's."""
    r = np.random.default_rng(zlib.crc32(
        c["name"].replace("hier/", "chain/").encode()))
    n = c["n"]
    out = dict(g=r.standard_normal((K, n)).astype(np.float32),
               e=(0.05 * r.standard_normal((K, n))).astype(np.float32),
               pe=(0.02 * r.standard_normal((K, n // KD))).astype(
                   np.float32))
    if c["name"].startswith("mass/"):
        out["pe"] = np.zeros_like(out["pe"])
    if c["mask_step"] is not None:
        gm = np.zeros((n,), np.float32)
        gm[::c["mask_step"]] = 1.0
        out["gm"] = gm
    if c["part"]:
        out["part"] = np.asarray(PART, np.float32)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory, multidev):
    d = tmp_path_factory.mktemp("segments_nested")
    arrays = {f"{c['name']}/{k}": v for c in CASES
              for k, v in _inputs(c).items()}
    np.savez(d / "in.npz", **arrays)
    script = (f"INPUTS = {str(d / 'in.npz')!r}\n"
              f"OUTPUTS = {str(d / 'out.npz')!r}\n"
              f"CASES = {json.dumps(CASES)!r}\n"
              f"TREES = {json.loads(json.dumps(TREES))!r}\n"
              f"INTER = {INTER!r}\n" + REFERENCE)
    multidev(script, devices=K)
    return dict(np.load(d / "out.npz"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tree(par):
    return AggTree(parent=tuple(PS if p < 0 else p for p in par))


def _nested(kind: str):
    if kind == "chain":
        return pod_ring_nested(KP, KD)
    t0, t1 = TREES[kind]
    return compile_nested([[(tuple(range(0, 4)), _tree(t0)),
                            (tuple(range(4, 8)), _tree(t1))],
                           [((0, 1), _tree(INTER))]])


def _cfg(c):
    return AggConfig(kind=AggKind(c["kind"]), q=c["q"])


def _run(c, transport="auto"):
    """→ (final [K, seg2], EF [K, n], pod EF [K, n / KD], per stage a dict
    of per-rank stats) as numpy."""
    x = _inputs(c)
    kw = dict(global_mask=None if "gm" not in x else [_t(x["gm"])] * K,
              participate=None if "part" not in x else list(_t(x["part"])))
    g, e, pe = list(_t(x["g"])), list(_t(x["e"])), list(_t(x["pe"]))
    if c["fn"] == "hier":
        s2, ef, pef, st = hierarchical_ring_local(
            _cfg(c), MESH, g, e, pe, c["w"], sizes=SIZES, **kw)
        assert all(isinstance(s, HierStats) for s in st)
        stages = ([s.intra for s in st], [s.inter for s in st])
    else:
        s2, ef, (pef,), stages = run_nested_segments_local(
            _cfg(c), _nested(c["plan"]), MESH, g, e, (pe,), c["w"],
            sizes=SIZES, transport=transport, **kw)
    stack = lambda xs: torch.stack(xs).numpy()  # noqa: E731
    return (stack(s2), stack(ef), stack(pef),
            [{f: stack([getattr(s, f) for s in st])
              for f in ("bits", "nnz", "err_sq")} for st in stages])


def _bits_equal(a, b, msg):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.shape,
                                                        b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


_PORT: dict = {}


def _port(name, transport="auto"):
    if (name, transport) not in _PORT:
        _PORT[name, transport] = _run(BY_NAME[name], transport)
    return _PORT[name, transport]


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_nested_segments_match_the_reference(reference, name):
    fin, ef, pef, stages = _port(name)
    for key, got in (("final", fin), ("ef", ef), ("pef", pef)):
        _bits_equal(reference[f"{name}/{key}"], got, f"{name} {key}")
    for i, st in enumerate(stages):
        for f in ("bits", "nnz"):
            _bits_equal(reference[f"{name}/{i}/{f}"], st[f],
                        f"{name} stage {i} {f}")
        np.testing.assert_allclose(st["err_sq"],
                                   reference[f"{name}/{i}/err_sq"],
                                   rtol=ERR_RTOL, err_msg=name)


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if c["plan"] != "chain"])
def test_nested_segments_equal_the_staged_host_reference(name):
    """Stage 0 per data segment s on the merged forest (rank p·K_d + (k +
    s) mod K_d plays local k of pod p), stage 1 per (s, pod sub-segment t)
    on the stage-0 sink partials (pod (u + t) mod K_p plays u)."""
    c = BY_NAME[name]
    x = _inputs(c)
    cfg = _cfg(c)
    nested = _nested(c["plan"])
    st0, st1 = nested.stages
    n = c["n"]
    seg1, seg2 = n // KD, n // K
    gm = x.get("gm")
    part = np.asarray(x.get("part", np.ones(K)), np.float32)
    fin, ef, pef, stages = _port(name)
    bits = [0.0, 0.0]
    for s in range(KD):
        rows = np.asarray([p * KD + (k + s) % KD
                           for p in range(KP) for k in range(KD)])
        c1 = slice(s * seg1, (s + 1) * seg1)
        r0 = execute(cfg, st0, _t(x["g"][rows, c1]), _t(x["e"][rows, c1]),
                     torch.full((K,), c["w"]),
                     global_mask=None if gm is None else _t(gm[c1]),
                     participate=_t(part[rows]))
        bits[0] += float(r0.stats.bits.sum())
        for i, rr in enumerate(rows):
            _bits_equal(r0.e_new[i].numpy(), ef[rr, c1], f"{name} ef")
        for t in range(KP):
            urows = [(u + t) % KP for u in range(KP)]
            pe_rows = np.asarray([u * KD + s for u in urows])
            c2 = slice(t * seg2, (t + 1) * seg2)
            g2 = slice(s * seg1 + t * seg2, s * seg1 + (t + 1) * seg2)
            r1 = execute(cfg, st1, r0.aggregate[urows, c2].contiguous(),
                         _t(x["pe"][pe_rows, c2]), torch.ones((KP,)),
                         global_mask=None if gm is None else _t(gm[g2]))
            bits[1] += float(r1.stats.bits.sum())
            _bits_equal(r1.aggregate.numpy(), fin[t * KD + s],
                        f"{name} final s={s} t={t}")
            for u, rr in enumerate(pe_rows):
                _bits_equal(r1.e_new[u].numpy(), pef[rr, c2],
                            f"{name} pod ef s={s} t={t}")
    for i in range(2):
        assert float(stages[i]["bits"].sum()) == bits[i], (name, i)


def test_uniform_clusters_take_the_static_path_and_equal_the_butterfly():
    name = "uniform/cl_tc_sia"
    assert _nested("uniform").clustered[0].uniform()
    assert not _nested("tree").clustered[0].uniform()
    assert pod_ring_nested(4, 7).clustered[0].uniform()
    static = _port(name)
    bf = _port(name, "butterfly")
    for a, b in zip(static[:3], bf[:3]):
        _bits_equal(a, b, name)
    for sa, sb in zip(static[3], bf[3]):
        for f in ("bits", "nnz", "err_sq"):
            _bits_equal(sa[f], sb[f], f)


def test_uniform_matches_the_reference_clustered_stage():
    """``ClusteredStage.uniform()`` answers as the reference's on the same
    stage specs."""
    jt = lambda par: JTree(parent=tuple(JPS if p < 0 else p  # noqa: E731
                                        for p in par))
    for plan in ("tree", "uniform"):
        t0, t1 = TREES[plan]
        ref = jnested.compile_nested(
            [[(tuple(range(0, 4)), jt(t0)), (tuple(range(4, 8)), jt(t1))],
             [((0, 1), jt(INTER))]])
        assert (_nested(plan).clustered[0].uniform()
                == ref.clustered[0].uniform())


@pytest.mark.parametrize("kind", ["cl_sia", "sia", "cl_tc_sia"])
def test_chain_x_chain_is_two_composed_rotated_rings(kind):
    """The historic two-stage program: a rotated ring over each pod's data
    ranks, then one over the pods on the owned segments with the pod EF
    and the mask slice; ``hierarchical_ring_local`` is the nested plan."""
    c = BY_NAME["chain/" + kind]
    x = _inputs(c)
    cfg = _cfg(c)
    n = c["n"]
    sg = n // KD
    gm = x.get("gm")
    s1, ef = [None] * K, [None] * K
    for p in range(KP):
        ranks = [p * KD + r for r in range(KD)]
        f, e, _ = rotated_ring_local(
            cfg, client_mesh(KD, devices=["cpu"] * KD),
            [_t(x["g"][r]) for r in ranks], [_t(x["e"][r]) for r in ranks],
            c["w"], global_mask=None if gm is None else [_t(gm)] * KD)
        for i, r in enumerate(ranks):
            s1[r], ef[r] = f[i], e[i]
    s2, pef = [None] * K, [None] * K
    for r in range(KD):
        ranks = [p * KD + r for p in range(KP)]
        f, e, _ = rotated_ring_local(
            cfg, client_mesh(KP, devices=["cpu"] * KP),
            [s1[q] for q in ranks], [_t(x["pe"][q]) for q in ranks], 1.0,
            global_mask=(None if gm is None
                         else [_t(gm[r * sg:(r + 1) * sg])] * KP))
        for i, q in enumerate(ranks):
            s2[q], pef[q] = f[i], e[i]
    for key, fin in (("chain/", _port("chain/" + kind)),
                     ("hier/", _port("hier/" + kind))):
        _bits_equal(torch.stack(s2).numpy(), fin[0], key + kind)
        _bits_equal(torch.stack(ef).numpy(), fin[1], key + kind + " ef")
        _bits_equal(torch.stack(pef).numpy(), fin[2], key + kind + " pef")


@pytest.mark.parametrize("kind", ["cl_sia", "dense_ia"])
def test_hierarchical_conserves_mass(kind):
    """The reference's ``HIER`` checks: Σ aggregate + Σ client EF + Σ pod EF
    = Σ (w·g + EF); dense equals the exact sum; CL keeps ≤ q per rank."""
    c = BY_NAME["mass/" + kind]
    x = _inputs(c)
    fin, ef, pef, _ = _port(c["name"])
    lhs = float(fin.sum()) + float(ef.sum()) + float(pef.sum())
    rhs = float((c["w"] * x["g"] + x["e"]).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)
    if kind == "dense_ia":
        want = np.sort((c["w"] * x["g"] + x["e"]).sum(0))
        np.testing.assert_allclose(want, np.sort(fin.reshape(-1)),
                                   rtol=2e-4, atol=1e-5)
    else:
        assert (np.count_nonzero(fin, axis=1) <= c["q"]).all()


def test_dci_analytic_model():
    flat, hier = dci_bytes_flat_vs_hier(2, 16, payload=1000)
    assert flat == 32_000 and hier == 2_000
    for args in ((4, 7, 281), (2, 16, 1000)):
        assert dci_bytes_flat_vs_hier(*args) == jhier.dci_bytes_flat_vs_hier(
            *args)


def test_nested_segments_errors():
    cfg = AggConfig(q=3)
    n = K * 4
    z = [torch.zeros(n)] * K
    pe = ([torch.zeros(n // KD)] * K,)
    chain = pod_ring_nested(KP, KD)
    with pytest.raises(TypeError, match="NestedPlan"):
        run_nested_segments_local(cfg, chain.stages[0], MESH, z, z, pe, 1.0,
                                  sizes=SIZES)
    with pytest.raises(ValueError, match="axis sizes were given"):
        run_nested_segments_local(cfg, chain, MESH, z, z, pe, 1.0,
                                  sizes=(K,))
    with pytest.raises(ValueError, match="stage-EF"):
        run_nested_segments_local(cfg, chain, MESH, z, z, (), 1.0,
                                  sizes=SIZES)
    with pytest.raises(ValueError, match="provide 4 ranks but the mesh"):
        run_nested_segments_local(cfg, pod_ring_nested(2, 2), MESH, z, z, pe,
                                  1.0, sizes=(2, 2))
    with pytest.raises(ValueError, match="8 clients but the axes"):
        run_nested_segments_local(cfg, chain, MESH, z, z, pe, 1.0,
                                  sizes=(2, 2))
    with pytest.raises(ValueError, match="clusters have 4 members"):
        run_nested_segments_local(cfg, chain, MESH, z, z, pe, 1.0,
                                  sizes=(2, 4))
    split = compile_nested([[((0, 2, 4, 6), None), ((1, 3, 5, 7), None)],
                            [((0, 1), None)]])
    with pytest.raises(ValueError, match="not mesh-aligned"):
        run_nested_segments_local(cfg, split, MESH, z, z, pe, 1.0,
                                  sizes=SIZES)
    with pytest.raises(ValueError, match="per-cluster trees route through"):
        run_nested_segments_local(cfg, _nested("tree"), MESH, z, z, pe, 1.0,
                                  sizes=SIZES, transport="static")
    with pytest.raises(ValueError, match="unknown transport"):
        run_nested_segments_local(cfg, chain, MESH, z, z, pe, 1.0,
                                  sizes=SIZES, transport="tree")
