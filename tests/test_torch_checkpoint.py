"""The port's checkpoints (``repro_torch.checkpoint``) and their exchange
with the reference's.

Reference twin: ``tests/test_checkpoint.py``. The port's own round trip
(bfloat16 leaves included), ``keep_n`` GC, ``latest_step`` ignoring a
partial ``.tmp`` directory, the leaf-count check; and the **cross-read**:
a reference ``TrainState`` (nested topology, so ``stage_ef`` rides along;
bfloat16 EF; a TCS ``tcs_prev``) saved by ``repro`` restores into the
port's ``TrainState`` bit for bit, and the port's saved state restores
into the reference's bit for bit. Both packages write the same file names,
manifest key paths, shapes and dtypes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro import compat
from repro.configs.base import ModelConfig as RefModelConfig
from repro.core.algorithms import AggConfig as RefAggConfig
from repro.core.algorithms import AggKind as RefAggKind
from repro.train import init_state as ref_init_state
from repro.train.state import TrainConfig as RefTrainConfig
from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import TrainConfig, init_state
from repro_torch.train.state import abstract_like

torch.set_num_threads(1)

TINY = dict(name="tiny", family="dense", num_layers=1, d_model=32,
            num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
            head_dim=16, param_dtype="bfloat16")
TC = dict(q_frac=0.05, agg_dtype="bfloat16", ef_dtype="bfloat16")


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.randn(4, generator=g).to(torch.bfloat16)},
            "ef": torch.randn(3, 32, generator=g),
            "step": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree):
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    return _flatten_with_paths(tree)


def test_roundtrip_and_ef_survive(tmp_path):
    s = _state()
    ckpt.save(str(tmp_path), 7, s)
    r = ckpt.restore(str(tmp_path), abstract_like(s), device="cpu")
    for (pa, a), (pb, b) in zip(_leaves(s), _leaves(r)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    r2 = ckpt.restore(str(tmp_path), s)       # a real template's device
    assert torch.equal(r2["ef"], s["ef"])
    with pytest.raises(ValueError, match="meta"):
        ckpt.restore(str(tmp_path), abstract_like(s))


def test_latest_keep_n_and_partial(tmp_path):
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) is None
    assert ckpt.latest_step(str(tmp_path / "absent")) is None
    for step in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), step, _state(step), keep_n=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")
                  and not d.endswith(".tmp"))
    assert kept == ["step_00000003", "step_00000004"]
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"params": torch.empty(8, 4)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "absent"), _state())


def _ref_state():
    mesh = compat.make_mesh((1, 1, 1), ("pod", "data", "model"))
    cfg = RefModelConfig(**TINY)
    tc = RefTrainConfig(agg=RefAggConfig(kind=RefAggKind.CL_TC_SIA, q=1),
                        **TC)
    st = ref_init_state(cfg, tc, mesh, jax.random.PRNGKey(3),
                        topology="hierarchical")
    # non-zero EF tiers and moments, so every leaf carries bits
    key = jax.random.PRNGKey(4)
    return st._replace(
        step=jnp.int32(5),
        ef=jax.random.normal(key, st.ef.shape).astype(st.ef.dtype),
        stage_ef=(jax.random.normal(jax.random.fold_in(key, 1),
                                    st.stage_ef[0].shape).astype(
            st.stage_ef[0].dtype),),
        opt=st.opt._replace(m=jax.random.normal(jax.random.fold_in(key, 2),
                                                st.opt.m.shape)))


def _port_template():
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), ["cpu"])
    tc = TrainConfig(agg=AggConfig(kind=AggKind.CL_TC_SIA, q=1), **TC)
    return init_state(ModelConfig(**TINY), tc, mesh,
                      torch.Generator().manual_seed(0),
                      topology="hierarchical")


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    st = _ref_state()
    ref_ckpt.save(str(tmp_path), 5, st)
    got = ckpt.restore(str(tmp_path), abstract_like(_port_template()),
                       device="cpu")
    paths, leaves, _ = ref_ckpt.checkpoint._flatten_with_paths(st)
    mine = _leaves(got)
    assert ["/".join(p) for p, _ in mine] == paths
    for (_, a), b in zip(mine, leaves):
        assert str(a.dtype).replace("torch.", "") == np.dtype(b.dtype).name
        np.testing.assert_array_equal(_np(a), _np(b))
    assert int(got.step) == 5 and got.stage_ef[0].dtype == torch.bfloat16


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    st = _port_template()
    g = torch.Generator().manual_seed(9)
    st = st._replace(step=torch.tensor(11, dtype=torch.int32),
                     ef=torch.randn(st.ef.shape, generator=g).to(st.ef.dtype))
    ckpt.save(str(tmp_path), 11, st)
    template = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype),
                            _ref_state())
    got = ref_ckpt.restore(str(tmp_path), template)
    ref_leaves = ref_ckpt.checkpoint._flatten_with_paths(got)[1]
    for (_, a), b in zip(_leaves(st), ref_leaves):
        np.testing.assert_array_equal(_np(a), _np(b))
    with open(tmp_path / "step_00000011" / "manifest.json") as f:
        port_manifest = json.load(f)
    ref_ckpt.save(str(tmp_path / "ref"), 11, got)
    with open(tmp_path / "ref" / "step_00000011" / "manifest.json") as f:
        assert json.load(f) == port_manifest
