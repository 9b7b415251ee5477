"""The resident forms of a level's node step against the JAX package.

``kops.tau_search_fused_level`` (the whole threshold τ search of a level)
and ``kops.cl_fuse_select_level`` (exact Top-Q support and the CL fuse)
run their plain versions here (``kernel_mode="ref"``), and each is held
against what the jitted reference computes for the same level: its
``threshold_for_topq`` over the fused-operand callbacks of
``repro.core.algorithms._tau_operand``, and its exact CL level (the
``_lane_sparsifier_state`` Top-Q mask, then ``cl_fuse_level``). The
whole level step of every kind is held the same way. The reference's
count kernel runs as its contract, ``count_ge_batch``'s broadcast
comparison, which the Pallas kernel meets (a NaN candidate counts
nothing); its jnp fallback sorts, and counts the NaN elements for a NaN
candidate, which only a lane holding a NaN shows. Inputs are numpy
arrays from a seed; lanes W ∈ {1, 3, 28} at d ∈ {281, 7850}; global masks
none, lane-shared [d], per-lane [W, d] and cohort-shared [B, d]; edge
lanes with ties straddling the q-th magnitude, NaN and ±inf, all zeros,
p = 0 and valid = 0; q ≤ 0, q = d and q > d.

Tolerance: none. τ, counts, masks, outputs and integers are compared bit
for bit (``view(int32)``), except that a NaN equals any NaN: the search
of a lane holding a NaN ends in a NaN τ, whose payload is the device's
arithmetic's (it differs between x86 and the card), not the search's.
``err_sq`` is the pinned fold under ``err_sq_mode="kernel"`` (bit for
bit) and a row sum under ``"jnp"`` (rtol 1e-6, as in the other files).
The dispatch rule's boundary is checked at the largest resident d and at
d + 1, where the level takes the multi-block kernels' chain.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as jalg
from repro.core import sparsify as jsp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import algorithms as talg
from repro_torch.core import sparsify as tsp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_launches import RESIDENT_BRANCH, RESIDENT_D

torch.set_num_threads(1)

KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia"]
BRANCH, ROUNDS = 64, 3
ERR_RTOL = 1e-6


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _same(want, got, msg=""):
    """Bit for bit, a NaN equal to any NaN."""
    a, b = np.asarray(want), got.detach().numpy()
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    if a.dtype == np.float32:
        nan = np.isnan(a)
        np.testing.assert_array_equal(nan, np.isnan(b), err_msg=msg)
        a, b = np.where(nan, 0, a.view(np.int32)), np.where(
            nan, 0, b.view(np.int32))
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _lanes(w, d, seed):
    return {k: v.numpy() for k, v in
            tref.resident_edge_lanes(w, d, seed).items()}


def _gmask(form, w, d, seed, cohorts=0):
    m = tref.resident_gmask(form, w, d, seed, cohorts)
    return None if m is None else m.numpy()


def _jcfg(kind="cl_sia", **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jalg.AggConfig(kind=kind, kernel_mode="ref", **kw)


def _tcfg(kind="cl_sia", **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return talg.AggConfig(kind=kind, kernel_mode="ref", **kw)


@pytest.fixture
def pallas_counts(monkeypatch):
    """The reference's fused-operand counts as its Pallas kernel computes
    them: ``count_ge_batch`` over the fused operand."""
    def counts(g, e, gamma_in, weight, participate, taus, gmask=None, *,
               include_gamma=False, gmask_cohorts=0, mode="auto"):
        op = jref.fused_operand(g, e, gamma_in, weight, participate, gmask,
                                include_gamma=include_gamma,
                                gmask_cohorts=gmask_cohorts)
        return jsp.count_ge_batch(jnp.abs(op), taus)
    monkeypatch.setattr(jops, "count_ge_fused_level", counts)


# ---------------------------------------------------------------------------
# the τ search
# ---------------------------------------------------------------------------

# (W, d, global mask, cohorts, include_gamma)
SEARCH_CASES = [(1, 281, None, 0, False), (3, 281, "shared", 0, False),
                (3, 281, "lanes", 0, True), (3, 281, "cohort", 3, True),
                (28, 281, "cohort", 4, False), (28, 7850, None, 0, True),
                (1, 7850, "shared", 0, True), (28, 7850, "lanes", 0, False)]


@pytest.mark.parametrize("case", SEARCH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_tau_search_matches_reference(case, pallas_counts):
    """τ and every round's counts of the resident search's plain version
    = the reference's ``threshold_for_topq`` over its fused-operand
    callbacks, for q ≤ 0, q = 11 and q > d."""
    w, d, form, cohorts, gamma = case
    x = _lanes(w, d, seed=w + d)
    gm = _gmask(form, w, d, seed=w + d, cohorts=cohorts)
    qs = (0, 11, d + 3)
    jcfg = _jcfg(hist_branch=BRANCH)

    def reference(g, e, gin, wv, p, m):
        op = jalg._tau_operand(jcfg, g, e, gin, wv, p, m, cohorts,
                               include_gamma=gamma)
        return [jsp.threshold_for_topq(None, q, branch=BRANCH, rounds=r,
                                       operand_fn=op, with_counts=True)
                for q in qs for r in (1, ROUNDS)]

    want = jax.jit(reference)(x["g"], x["e"], x["gin"], x["w"], x["p"], gm)
    args = tuple(map(_t, (x["g"], x["e"], x["gin"], x["w"], x["p"])))
    i = 0
    for q in qs:
        for r in (1, ROUNDS):
            tau, counts = tops.tau_search_fused_level(
                *args, _t(gm), q=q, branch=BRANCH, rounds=r,
                include_gamma=gamma, gmask_cohorts=cohorts, mode="ref")
            _same(want[i][0], tau, f"τ q={q} rounds={r}")
            _same(want[i][1], counts, f"counts q={q} rounds={r}")
            i += 1


def test_search_callback_is_the_whole_scan():
    """``threshold_for_topq(operand_fn=...)`` with a ``search`` returns
    what the search returns, and the rounds through ``count`` give the
    same τ and counts."""
    x = _lanes(3, 281, seed=5)
    args = tuple(map(_t, (x["g"], x["e"], x["gin"], x["w"], x["p"])))
    op = talg._tau_operand(_tcfg(hist_branch=BRANCH), *args[:2], args[2],
                           *args[3:], include_gamma=True)
    assert op.search is not None
    for q in (0, 11, 300):
        tau, counts = tsp.threshold_for_topq(None, q, operand_fn=op,
                                             branch=BRANCH, rounds=ROUNDS,
                                             with_counts=True)
        t2, c2 = tsp.threshold_for_topq(None, q, operand_fn=op._replace(
            search=None), branch=BRANCH, rounds=ROUNDS, with_counts=True)
        _same(t2.numpy(), tau, f"τ q={q}")
        _same(c2.numpy(), counts, f"counts q={q}")


# ---------------------------------------------------------------------------
# exact Top-Q and the CL fuse
# ---------------------------------------------------------------------------

# (W, d, global mask, cohorts)
SELECT_CASES = [(1, 281, None, 0), (3, 281, "shared", 0),
                (3, 281, "lanes", 0), (28, 281, "cohort", 4),
                (28, 7850, None, 0), (1, 7850, "shared", 0),
                (28, 7850, "lanes", 0), (3, 7850, "cohort", 3)]


@pytest.mark.parametrize("case", SELECT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cl_fuse_select_matches_reference(case):
    """γ_out, e′, nnz, nnz_off and the pinned ‖e′‖² of the resident
    exact CL step's plain version = the reference's exact CL level (its Top-Q
    mask from ``_lane_sparsifier_state``, then ``cl_fuse_level``), and the
    support it keeps = the reference's mask, for q ≤ 0, q = 11, q = d and
    q > d."""
    w, d, form, cohorts = case
    x = _lanes(w, d, seed=2 * w + d)
    gm = _gmask(form, w, d, seed=w, cohorts=cohorts)
    qs = (0, 11, d, d + 3)
    jcfg = _jcfg()

    def reference(g, e, gin, wv, p, valid, m):
        op = jalg._tau_operand(jcfg, g, e, gin, wv, p, m, cohorts,
                               include_gamma=True)
        outs = []
        for q in qs:
            mask, tau = jalg._lane_sparsifier_state(
                jcfg, op, q, jnp.ones_like(p), None)
            outs.append((mask, jops.cl_fuse_level(
                g, e, gin, wv, tau, p, valid, gmask=m, mask_in=mask,
                gmask_cohorts=cohorts, with_err=True, mode="ref")))
        return outs

    want = jax.jit(reference)(x["g"], x["e"], x["gin"], x["w"], x["p"],
                              x["valid"], gm)
    args = tuple(map(_t, (x["g"], x["e"], x["gin"], x["w"], x["p"])))
    operand = tref.fused_operand(*args, _t(gm), include_gamma=True,
                                 gmask_cohorts=cohorts)
    for q, (mask, outs) in zip(qs, want):
        _same(mask, tsp.topq_mask(operand, q), f"mask q={q}")
        for err in (False, True):
            got = tops.cl_fuse_select_level(
                *args, _t(x["valid"]), _t(gm), q=q, gmask_cohorts=cohorts,
                with_err=err, mode="ref")
            assert len(got) == 4 + err
            for name, a, b in zip(("γ", "e′", "nnz", "nnz_off", "err"),
                                  outs, got):
                _same(a, b, f"{name} q={q} with_err={err}")


# ---------------------------------------------------------------------------
# whole level steps
# ---------------------------------------------------------------------------

def _counting(monkeypatch, *names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(tref, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tref, name, wrapped)
    return calls


RESIDENT = ("ref_tau_search_fused_level", "ref_cl_fuse_select_level",
            "ref_count_ge_fused_level", "ref_cl_fuse_level")

# (kind, topq_impl, W, d, global mask form, err_sq_mode)
STEP_CASES = ([(k, "threshold", 3, 281, "shared", "jnp") for k in KINDS]
              + [("cl_sia", "exact", 3, 281, None, "kernel"),
                 ("cl_tc_sia", "exact", 3, 281, "shared", "jnp"),
                 ("cl_sia", "exact", 28, 7850, None, "kernel"),
                 ("cl_sia", "threshold", 28, 7850, None, "kernel"),
                 ("cl_tc_sia", "exact", 28, 7850, "lanes", "kernel"),
                 ("tc_sia", "threshold", 1, 7850, "shared", "jnp"),
                 ("cl_tc_sia", "threshold", 1, 7850, "lanes", "kernel")])


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_level_step_matches_reference(case, pallas_counts, monkeypatch):
    """One resident level of each kind = the reference's jitted level
    step (aggregate, EF rows, nnz, bits, ``err_sq``), through one resident
    call per level and no count kernel or CL fuse of the chain."""
    kind, impl, w, d, form, err_mode = case
    x = _lanes(w, d, seed=3 * w + d)
    gm = _gmask(form, w, d, seed=d)
    if gm is None:
        gm = np.zeros((d,), np.float32)
    kw = dict(q=11, topq_impl=impl, hist_branch=BRANCH,
              hist_rounds=ROUNDS, err_sq_mode=err_mode)
    jstep = jalg.level_step(_jcfg(kind, **kw))
    want = jax.jit(jstep)(x["g"], x["gin"], x["e"], x["w"], x["p"], gm,
                          None, x["valid"])
    calls = _counting(monkeypatch, *RESIDENT)
    got = talg.level_step(_tcfg(kind, **kw))(
        *map(_t, (x["g"], x["gin"], x["e"], x["w"], x["p"], gm)), None,
        _t(x["valid"]))
    cl_exact = impl == "exact" and kind.startswith("cl_")
    assert calls == {"ref_tau_search_fused_level": int(impl == "threshold"),
                     "ref_cl_fuse_select_level": int(cl_exact),
                     "ref_count_ge_fused_level": 0,
                     "ref_cl_fuse_level": int(kind.startswith("cl_")
                                              and not cl_exact)}, calls
    _same(want[0], got[0], "aggregate")
    _same(want[1], got[1], "e_new")
    for name in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same(getattr(want[2], name), getattr(got[2], name), name)
    if err_mode == "kernel":
        _same(want[2].err_sq, got[2].err_sq, "err_sq")
    else:
        np.testing.assert_allclose(np.asarray(want[2].err_sq),
                                   got[2].err_sq.numpy(), rtol=ERR_RTOL)


@pytest.mark.parametrize("kind,impl", [("cl_tc_sia", "exact"),
                                       ("cl_tc_sia", "threshold"),
                                       ("tc_sia", "threshold")])
def test_cohort_level_step_matches_reference(kind, impl, pallas_counts):
    """Three cohorts of a W = 1 level with a cohort-shared [B, d] mask
    (``level_step_batched``) = the reference's batched level step."""
    b, w, d = 3, 1, 281
    x = _lanes(b * w, d, seed=9)
    x = {k: v.reshape((b, w) + v.shape[1:]) for k, v in x.items()}
    gm = _gmask("cohort", w, d, seed=9, cohorts=b)
    kw = dict(q=11, topq_impl=impl, hist_branch=BRANCH,
              hist_rounds=ROUNDS, err_sq_mode="kernel")
    want = jax.jit(jalg.level_step_batched(_jcfg(kind, **kw)))(
        x["g"], x["gin"], x["e"], x["w"], x["p"], gm, None, x["valid"])
    got = talg.level_step_batched(_tcfg(kind, **kw))(
        *map(_t, (x["g"], x["gin"], x["e"], x["w"], x["p"], gm)), None,
        _t(x["valid"]))
    _same(want[0], got[0], "aggregate")
    _same(want[1], got[1], "e_new")
    for name in ("nnz_out", "nnz_global", "nnz_local", "bits", "err_sq"):
        _same(getattr(want[2], name), getattr(got[2], name), name)


# ---------------------------------------------------------------------------
# the dispatch rule
# ---------------------------------------------------------------------------

def test_dispatch_rule_boundary(monkeypatch):
    """The largest resident d takes the resident forms, d + 1 the chain
    of the multi-block kernels; both give the unfused bodies' numbers."""
    top = tops.RESIDENT_MAX_D
    # the limits the launch gates (tests/_torch_launches.py) state
    assert (top, tops.RESIDENT_MAX_BRANCH) == (RESIDENT_D, RESIDENT_BRANCH)
    assert tops.resident_level(top) and not tops.resident_level(top + 1)
    assert tops.resident_level(top, tops.RESIDENT_MAX_BRANCH)
    assert not tops.resident_level(top, tops.RESIDENT_MAX_BRANCH + 1)
    for d, resident in ((top, True), (top + 1, False)):
        x = _lanes(1, d, seed=d)
        gm = np.zeros((d,), np.float32)
        args = tuple(map(_t, (x["g"], x["gin"], x["e"], x["w"], x["p"],
                              gm)))
        for impl in ("exact", "threshold"):
            cfg = _tcfg("cl_sia", q=78, topq_impl=impl, hist_branch=BRANCH,
                        hist_rounds=ROUNDS)
            calls = _counting(monkeypatch, *RESIDENT)
            got = talg.level_step(cfg)(*args)
            monkeypatch.undo()
            search = impl == "threshold"
            assert calls == {
                "ref_tau_search_fused_level": int(resident and search),
                "ref_cl_fuse_select_level": int(resident and not search),
                "ref_count_ge_fused_level": 0 if resident or not search
                else ROUNDS,
                "ref_cl_fuse_level": int(search or not resident)}, (
                    d, impl, calls)
            want = talg.level_step(dataclasses.replace(
                cfg, kernel_mode="never"))(*args)
            for u, v in zip(want[:2] + tuple(want[2][:4]),
                            got[:2] + tuple(got[2][:4])):
                assert torch.equal(u, v), (d, impl)


def test_resident_entries_refuse_other_shapes():
    """A direct call outside the rule raises on the kernels' wrappers; the
    plain versions take any d."""
    from repro_torch.kernels import level
    d = tops.RESIDENT_MAX_D + 1
    with pytest.raises(ValueError):
        level._resident(d)
    with pytest.raises(ValueError):
        level._resident(7850, tops.RESIDENT_MAX_BRANCH + 1)
    with pytest.raises(RuntimeError):
        tops.cl_fuse_select_level(*(torch.zeros((1, 8)),) * 3,
                                  *(torch.ones(1),) * 3, q=2, mode="always")
    level._resident(tops.RESIDENT_MAX_D, tops.RESIDENT_MAX_BRANCH)
    assert level.RESIDENT_MAX_D == tops.RESIDENT_MAX_D
    assert level.cl_fuse_select_level_cuda in level.KERNELS
    assert level.tau_search_fused_level_cuda in level.KERNELS
