"""The port's fault handling against the JAX package's.

``heal_chain``, ``deadline_mask``, ``banked_mass`` and ``dead_banked_mass``
are compared with the reference on the same arrays (bit for bit; the two
masses are sums, compared to rtol 1e-6). The reference's straggler process
draws with ``jax.random`` and the port's from a ``torch.Generator``, so
the realized masks differ: ``StragglerModel`` is held to the process
itself (p = 0 gives all ones, the straggle rate is near ``p_straggle``,
slow clients recover at ``p_recover``), and the reference's realized masks
go through the port's simulator as ``participate_fn``. The cases of
``tests/test_fault.py`` and ``tests/test_fault_props.py`` follow.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.runtime import fault as jfault
from repro_torch.configs import PAPER
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.core.chain import run_chain
from repro_torch.data import make_synthetic_mnist, partition_iid
from repro_torch.fed import Simulator
from repro_torch.fed import simulator as tsim
from repro_torch.runtime import fault

torch.set_num_threads(1)


def test_heal_chain_matches_reference():
    order = np.asarray([2, 0, 5, 1, 4, 3], np.int32)
    for dead in (3, {0, 4}, [3], (), np.int64(5)):
        got = fault.heal_chain(order, dead)
        want = jfault.heal_chain(order, dead)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(fault.heal_chain(np.arange(6), 3),
                                  [0, 1, 2, 4, 5])


def test_deadline_mask_matches_reference():
    times = np.asarray([0.5, 2.0, 0.9, 1.0], np.float32)
    np.testing.assert_array_equal(fault.deadline_mask(times, 1.0).numpy(),
                                  np.asarray(jfault.deadline_mask(times, 1.0)))


def test_banked_masses_match_reference():
    rng = np.random.default_rng(4)
    ef = rng.standard_normal((9, 301)).astype(np.float32)
    part = np.asarray([1, 0, 1, 1, 0.5, 0, 1, 2, -1], np.float32)
    np.testing.assert_allclose(fault.banked_mass(torch.from_numpy(ef)),
                               np.asarray(jfault.banked_mass(ef)), rtol=1e-6)
    np.testing.assert_allclose(
        float(fault.dead_banked_mass(torch.from_numpy(ef),
                                     torch.from_numpy(part))),
        float(jfault.dead_banked_mass(ef, part)), rtol=1e-6)
    # the simulator module keeps the old import path
    assert tsim.banked_mass is fault.banked_mass
    assert tsim.dead_banked_mass is fault.dead_banked_mass


def test_p_zero_all_participate():
    m = fault.StragglerModel(p_straggle=0.0).sample(torch.Generator(), 9)
    assert m.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), np.ones(9, np.float32))


@pytest.mark.parametrize("p", [0.1, 0.3, 0.7])
def test_straggle_rate_is_near_p(p):
    sm = fault.StragglerModel(p_straggle=p)
    gen = torch.Generator().manual_seed(1)
    masks = torch.stack([sm.sample(gen, 500) for _ in range(20)])
    assert set(np.unique(masks.numpy())) <= {0.0, 1.0}
    rate = 1.0 - float(masks.mean())
    # 10,000 Bernoulli draws: 5 standard deviations is under 0.023
    assert abs(rate - p) < 0.025, rate


def test_seed_stream_determinism():
    sm = fault.StragglerModel(p_straggle=0.4, correlated=True,
                              p_recover=0.3)

    def realize():
        gen, prev, out = torch.Generator().manual_seed(7), None, []
        for _ in range(6):
            prev = sm.sample(gen, 16, prev)
            out.append(prev)
        return torch.stack(out)

    assert torch.equal(realize(), realize())


@pytest.mark.parametrize("p_recover", [0.0, 0.25, 1.0])
def test_slow_clients_recover_at_p_recover(p_recover):
    """correlated: a client slow last round is slow again unless it
    recovers (rate p_recover) and is then drawn fast; a client fast last
    round draws the uncorrelated mask."""
    p, k = 0.3, 4000
    sm = fault.StragglerModel(p_straggle=p, correlated=True,
                              p_recover=p_recover)
    prev = torch.zeros(k)
    prev[k // 2:] = 1.0
    m = sm.sample(torch.Generator().manual_seed(3), k, prev)
    slow_again = 1.0 - float(m[:k // 2].mean())
    want = 1.0 - (1.0 - p) * p_recover
    assert abs(slow_again - want) < 0.04, (slow_again, want)
    assert abs((1.0 - float(m[k // 2:].mean())) - p) < 0.04
    # no prev: the plain process
    free = sm.sample(torch.Generator().manual_seed(3), k)
    assert abs(1.0 - float(free.mean()) - p) < 0.04


def test_straggler_mass_recovered_next_round():
    """A client that straggles in round 1 banks its gradient and sends it
    in round 2: both rounds' aggregates together equal two rounds without
    straggling (q = d, so nothing else is held back)."""
    k, d = 5, 120
    cfg = AggConfig(kind=AggKind.CL_SIA, q=d)
    rng = np.random.default_rng(0)
    g1, g2 = (torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32))
              for _ in range(2))
    w = torch.ones(k)
    part = torch.tensor([1., 1., 0., 1., 1.])
    r1 = run_chain(cfg, g1, torch.zeros(k, d), w, participate=part)
    r2 = run_chain(cfg, g2, r1.e_new, w)
    f1 = run_chain(cfg, g1, torch.zeros(k, d), w)
    f2 = run_chain(cfg, g2, f1.e_new, w)
    np.testing.assert_allclose((r1.aggregate + r2.aggregate).numpy(),
                               (f1.aggregate + f2.aggregate).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_straggler_banked_mass_visible():
    k, d = 4, 50
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (k, d), dtype=np.float32))
    r = run_chain(AggConfig(kind=AggKind.SIA, q=5), g, torch.zeros(k, d),
                  torch.ones(k), participate=torch.tensor([1., 0., 1., 1.]))
    bm = fault.banked_mass(r.e_new).numpy()
    assert bm[1] > bm[0] and bm[1] > bm[2]


def test_sim_with_reference_straggler_masks_converges():
    """The reference's realized straggler masks drive the port's
    simulator (30 % stragglers, K = 8), and it still trains."""
    k = 8
    pc = dataclasses.replace(PAPER, num_clients=k)
    train = make_synthetic_mnist(0, k * 100, device="cpu")
    test = make_synthetic_mnist(1, 500, device="cpu")
    fed = partition_iid(train, k, torch.Generator().manual_seed(2))
    sm = jfault.StragglerModel(p_straggle=0.3)
    masks = [np.asarray(sm.sample(jax.random.PRNGKey(1000 + r), k))
             for r in range(40)]
    sim = Simulator(pc, AggConfig(kind=AggKind.CL_SIA, q=pc.q), fed,
                    device="cpu")
    out = sim.run(40, test_x=test.x, test_y=test.y, eval_every=39,
                  participate_fn=lambda r, s: np.array(masks[r]))
    assert out["accuracy"][-1][1] > 0.85, out["accuracy"]
    assert out["loss"][-1] < out["loss"][0]
