"""The port's shard-aligned flat layout (``repro_torch.core.flat_layout``,
``models/partition.py``, the ring's flat helpers) against the reference's.

Reference twins: ``tests/test_flat_layout.py`` (the round trip on a
(2, 4) mesh with 6 heads, so attention leaves replicate with padding) and
``test_flat_layout_props.py``. The reference's ``FlatLayout`` and
``param_pspecs`` read only a mesh's ``shape`` and ``axis_names``, so they
run here in-process on a stand-in mesh; its ``local_flatten`` takes each
model column's shards (cut with numpy) outside ``shard_map``. Bit for bit
on (4, 1), (4, 2) and (2, 2, 2) for the tiny 6-head model, an odd-width
one (replicated leaves padded to the columns) and every SMOKE
architecture: the specs, every ``LeafPlan``, ``n_local``, ``tail_pad``,
``d_flat``, each column's flat piece, and the port's round trips.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs.base import ModelConfig as RefModelConfig
from repro.core import ring as ref_ring
from repro.core.flat_layout import FlatLayout as RefLayout
from repro.models import model as ref_model
from repro.models import partition as ref_partition
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ring
from repro_torch.core.flat_layout import FlatLayout
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as lm
from repro_torch.models import partition
from repro_torch.models.transformer import tree_leaves

torch.set_num_threads(1)

MESHES = [((4, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
SIX_HEADS = dict(name="t", family="dense", num_layers=2, d_model=32,
                 num_heads=6, num_kv_heads=2, d_ff=64, vocab_size=128,
                 head_dim=8, param_dtype="float32")
# odd widths: replicated norms of 30 and 3·30 entries pad to the columns
ODD = dict(SIX_HEADS, name="odd", d_model=30, num_layers=3)
TINY_MODELS = {"six-heads": SIX_HEADS, "odd-width": ODD}
MODELS = list(TINY_MODELS) + ARCHS


def _configs(name):
    if name in TINY_MODELS:
        kw = TINY_MODELS[name]
        return RefModelConfig(**kw), ModelConfig(**kw)
    return (dataclasses.replace(ref_get_config(name, smoke=True),
                                param_dtype="float32"),
            dataclasses.replace(get_config(name, smoke=True),
                                param_dtype="float32"))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(name):
        if name not in cache:
            rcfg, _ = _configs(name)
            cache[name] = jax.tree.map(
                np.asarray, ref_model.init_params(rcfg, jax.random.PRNGKey(0)))
        return cache[name]
    return get


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("name", MODELS)
def test_layout_equals_the_reference(ref_params, name, shape, axes):
    rcfg, cfg = _configs(name)
    stand_in = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                     axis_names=axes)
    mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    rspecs = ref_partition.param_pspecs(rcfg, stand_in)
    specs = partition.param_pspecs(cfg, mesh)
    r_leaves = jax.tree.leaves(rspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert [tuple(s) for s in r_leaves] == tree_leaves(specs)
    ref = RefLayout(ref_model.param_specs(rcfg), rspecs, stand_in)
    port = FlatLayout(lm.param_specs(cfg), specs, mesh)
    for a, b in zip(ref.plans, port.plans):
        assert (a.global_shape, a.local_shape, a.model_dim, a.local_size,
                a.pad) == (b.global_shape, b.local_shape, b.model_dim,
                           b.local_size, b.pad)
        assert np.dtype(a.dtype).name == str(b.dtype).replace("torch.", "")
    assert (ref.n_local, ref.tail_pad, ref.d_flat, ref.k_dp, ref.m) == (
        port.n_local, port.tail_pad, port.d_flat, port.k_dp, port.m)

    params = ref_params(name)
    leaves = jax.tree.leaves(params)
    p_leaves = tree_leaves(convert.lm_params(params, "cpu"))
    cols = []
    for m in range(port.m):
        shards = []
        for plan, x in zip(ref.plans, leaves):
            if plan.model_dim is not None:
                w = plan.local_shape[plan.model_dim]
                x = np.take(x, np.arange(m * w, (m + 1) * w),
                            axis=plan.model_dim)
            shards.append(jnp.asarray(x))
        want = np.asarray(ref.local_flatten(shards, m, jnp.float32))
        got_whole = port.local_flatten(p_leaves, m, torch.float32)
        got_shard = port.local_flatten(
            [torch.as_tensor(np.asarray(x)) for x in shards], m,
            torch.float32)
        assert np.array_equal(_bits(want), _bits(got_whole.numpy()))
        assert np.array_equal(_bits(want), _bits(got_shard.numpy()))
        cols.append(got_whole)
    flat = port.flatten(p_leaves)
    assert torch.equal(flat, torch.cat(cols))
    for a, b in zip(port.unflatten(flat), p_leaves):
        assert torch.equal(a, b)
    for m in range(port.m):
        for plan, a, b in zip(port.plans, port.local_unflatten(flat, m),
                              p_leaves):
            if plan.model_dim is None:
                assert torch.equal(a, b)       # reassembled from M columns
            else:
                w = plan.local_shape[plan.model_dim]
                assert torch.equal(a, b.narrow(plan.model_dim, m * w, w))


@pytest.mark.parametrize("name,m", [("six-heads", 4), ("odd-width", 4),
                                    ("odd-width", 2)])
def test_replicated_leaves_round_trip(name, m):
    cfg = ModelConfig(**TINY_MODELS[name])
    mesh = make_mesh((2, m), ("data", "model"), ["cpu"] * (2 * m))
    layout = FlatLayout(lm.param_specs(cfg), partition.param_pspecs(cfg, mesh),
                        mesh)
    assert layout.n_local % layout.k_dp == 0
    assert any(p.model_dim is None for p in layout.plans)
    if name == "odd-width" and m == 4:
        assert any(p.model_dim is None and p.pad for p in layout.plans)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    back = layout.unflatten(layout.flatten(tree_leaves(params)))
    for a, b in zip(back, tree_leaves(params)):
        assert torch.equal(a, b)
    # the whole mass survives the flat layout
    tot = sum(float(x.abs().sum()) for x in tree_leaves(params))
    np.testing.assert_allclose(float(layout.flatten(
        tree_leaves(params)).abs().sum()), tot, rtol=1e-5)


def test_ring_flat_helpers_equal_the_reference(ref_params):
    rcfg, cfg = _configs("six-heads")
    params = ref_params("six-heads")
    p = convert.lm_params(params, "cpu")
    d_pad = ref_ring.padded_flat_dim(params, 8)
    assert ring.padded_flat_dim(p, 8) == d_pad
    assert ring.padded_flat_dim(lm.param_specs(cfg), 8) == d_pad
    want = np.asarray(ref_ring.flatten_tree(params, d_pad))
    got = ring.flatten_tree(p, d_pad)
    assert np.array_equal(_bits(want), _bits(got.numpy()))
    back = ring.unflatten_tree(p, got)
    for a, b in zip(tree_leaves(back), tree_leaves(p)):
        assert torch.equal(a, b)
    stacked = jax.tree.map(lambda x: np.stack([x, -x]), params)
    want = np.asarray(ref_ring.flatten_stacked(stacked, d_pad))
    got = ring.flatten_stacked(convert.lm_params(stacked, "cpu"), d_pad)
    assert np.array_equal(_bits(want), _bits(got.numpy()))
