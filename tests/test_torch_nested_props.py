"""Property tests (hypothesis) of the port's nested plans, the two
properties of ``tests/test_nested_plan_props.py`` that hold in the
reference, over arbitrary cluster partitions (random member assignment,
random intra trees, random inter tree):

* dense nested aggregation is the exact sum, whatever the clustering, and
  its plan equals the reference's plan of the same stage spec;
* mass conservation per stage for the five sparse algorithms: aggregate +
  client EF + every stage EF tier = Σ (w·g + e), and the round equals the
  jitted reference's bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.agg import nested as jn  # noqa: E402
from repro.core.algorithms import AggConfig as JCfg  # noqa: E402
from repro.topo.tree import AggTree as JAggTree  # noqa: E402
from repro_torch.agg.nested import compile_nested, execute_nested  # noqa: E402
from repro_torch.core.algorithms import AggConfig, AggKind  # noqa: E402
from repro_torch.topo.tree import PS, AggTree  # noqa: E402

torch.set_num_threads(1)

K, D = 8, 64
ALL_SPARSE = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia"]


def _random_spec(seed, num_clusters, tree_cls):
    """A two-stage spec: a random partition of the K clients, a random
    local tree per cluster (node i's parent in i+1..m−1 or the sink), a
    random inter tree."""
    rng = np.random.default_rng(seed)

    def tree(m):
        parent = []
        for i in range(m - 1):
            p = int(rng.integers(i + 1, m + 1))
            parent.append(PS if p == m else p)
        parent.append(PS)
        return tree_cls(parent=tuple(parent))

    perm = rng.permutation(K)
    cuts = (sorted(rng.choice(np.arange(1, K), size=num_clusters - 1,
                              replace=False).tolist())
            if num_clusters > 1 else [])
    members = np.split(perm, cuts)
    stage0 = [(tuple(int(i) for i in mem), tree(len(mem)))
              for mem in members]
    return [stage0, [(tuple(range(len(members))), tree(len(members)))]]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((K, D), dtype=np.float32)
    e = rng.standard_normal((K, D), dtype=np.float32) * np.float32(0.1)
    return torch.from_numpy(g), torch.from_numpy(e), torch.ones((K,))


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 10_000), clusters=st.integers(1, 4))
def test_dense_nested_is_exact_sum(seed, clusters):
    nested = compile_nested(_random_spec(seed, clusters, AggTree),
                            num_clients=K)
    jplan = jn.compile_nested(_random_spec(seed, clusters, JAggTree),
                              num_clients=K)
    assert nested.shape == jplan.shape
    for a, b in zip(jplan.stages, nested.stages):
        np.testing.assert_array_equal(np.asarray(a.parent_row),
                                      b.parent_row)
    g, e, w = _inputs(seed % 97)
    res = execute_nested(AggConfig(kind=AggKind.DENSE_IA), nested, g, e, w)
    np.testing.assert_allclose(res.aggregate.numpy(), (g + e).sum(0).numpy(),
                               rtol=1e-5, atol=1e-5)


@settings(max_examples=20, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 10_000), clusters=st.integers(1, 4),
       kind=st.sampled_from(ALL_SPARSE), q=st.integers(1, 16))
def test_mass_conservation_per_stage(seed, clusters, kind, q):
    cfg = AggConfig(kind=AggKind(kind), q=q)
    nested = compile_nested(_random_spec(seed, clusters, AggTree),
                            num_clients=K)
    g, e, w = _inputs(seed % 89)
    gm = None
    if cfg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA):
        gm = torch.zeros((D,))
        gm[:cfg.q_global] = 1.0
    res = execute_nested(cfg, nested, g, e, w, global_mask=gm)
    lhs = (float(res.aggregate.sum()) + float(res.e_new.sum())
           + sum(float(x.sum()) for x in res.stage_e_new))
    np.testing.assert_allclose(lhs, float((g + e).sum()), rtol=1e-3,
                               atol=1e-3)
    jplan = jn.compile_nested(_random_spec(seed, clusters, JAggTree),
                              num_clients=K)
    want = jax.jit(lambda p, g, e, w, gm: jn.execute_nested(
        JCfg(kind=kind, q=q), p, g, e, w, global_mask=gm))(
            jplan, g.numpy(), e.numpy(), w.numpy(),
            None if gm is None else gm.numpy())
    for a, b in [(want.aggregate, res.aggregate), (want.e_new, res.e_new)] \
            + list(zip(want.stage_e_new, res.stage_e_new)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy().view(np.int32))
