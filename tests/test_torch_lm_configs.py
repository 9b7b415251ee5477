"""The port's architecture registry and config dataclasses against the
JAX reference's, and the port's meta-device param and cache trees against
the reference's ``jax.eval_shape`` trees.

All 20 configs (FULL and SMOKE of each of the ten architectures) equal
field for field, with the same derived properties, parameter counts and
shape cells; ``ModelConfig.dtype`` is the ``torch.dtype`` of the
reference's ``jnp.dtype``. ``param_specs`` and ``cache_specs`` build on
``torch.device("meta")`` (no allocation, also at FULL size) with the
reference's keys, shapes and dtypes, and allocate nothing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_lm import flat
from repro import configs as rc
from repro.models import model as ref_model
from repro_torch import configs as tc
from repro_torch.models import model as lm

torch.set_num_threads(1)

CONFIGS = [(a, s) for a in rc.ARCHS for s in (False, True)]
IDS = [f"{a}{'-smoke' if s else ''}" for a, s in CONFIGS]


def test_registry_order_and_unknown_arch():
    assert tc.ARCHS == rc.ARCHS
    with pytest.raises(KeyError) as got:
        tc.get_config("gpt-2")
    with pytest.raises(KeyError) as want:
        rc.get_config("gpt-2")
    assert str(got.value) == str(want.value)
    assert tc.PAPER == tc.PaperConfig()


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=IDS)
def test_config_fields_properties_and_counts(arch, smoke):
    got, want = (tc.get_config(arch, smoke=smoke),
                 rc.get_config(arch, smoke=smoke))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("resolved_head_dim", "padded_vocab", "d_inner",
                 "ssm_heads", "is_subquadratic"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.dtype == getattr(torch, want.dtype.name)
    assert tc.shape_cells(got) == rc.shape_cells(want)


def test_shapes():
    assert {k: dataclasses.asdict(v) for k, v in tc.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rc.SHAPES.items()}
    assert [v.is_decode for v in tc.SHAPES.values()] == [
        v.is_decode for v in rc.SHAPES.values()]


def _same_specs(got, want):
    g, w = flat(got), flat(jax.tree.map(lambda s: s, want))
    assert sorted(g) == sorted(w)
    for k, spec in w.items():
        assert g[k].is_meta, k
        assert tuple(g[k].shape) == tuple(spec.shape), k
        assert g[k].dtype == getattr(torch, np.dtype(spec.dtype).name), k


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=IDS)
def test_param_and_cache_specs_match_eval_shape(arch, smoke):
    got_cfg = tc.get_config(arch, smoke=smoke)
    want_cfg = rc.get_config(arch, smoke=smoke)
    _same_specs(lm.param_specs(got_cfg), ref_model.param_specs(want_cfg))
    # max_len 48 beside mixtral SMOKE's window 32: a 32-slot SWA ring
    for batch, max_len in ((2, 48), (1, 7)):
        _same_specs(lm.cache_specs(got_cfg, batch, max_len),
                    ref_model.cache_specs(want_cfg, batch, max_len))


def test_swa_cache_is_a_ring_of_the_window():
    cfg = tc.get_config("mixtral-8x7b", smoke=True)
    specs = lm.cache_specs(cfg, 2, 100)
    assert specs["layers"]["k"].shape == (2, 2, cfg.sliding_window, 2, 16)
    full = lm.cache_specs(tc.get_config("mixtral-8x7b"), 4, 544)
    assert full["layers"]["k"].shape == (32, 4, 544, 8, 128)


def test_init_params_and_cache_allocate_real_tensors_on_the_cpu():
    """Each stacked cache layer is its own memory (no broadcast view), and
    init_params draws the reference's leaf count and parameter count."""
    cfg = tc.get_config("zamba2-1.2b", smoke=True)
    cache = lm.init_cache(cfg, 2, 16, "cpu")
    k = cache["shared"]["k"]
    k[0].fill_(1.0)
    assert float(k[1].abs().sum()) == 0.0
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = flat(params)
    assert sorted(leaves) == sorted(flat(lm.param_specs(cfg)))
    assert all(not t.is_meta for t in leaves.values())
