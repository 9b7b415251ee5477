"""The resident SIA, RE-SIA and TC-SIA node step against the JAX package.

``kops.ia_fuse_select_level`` (the keep mask — the exact Top-Q support of
q or ``|x| ≥ τ`` for a given τ — error feedback, the sparsify and the IA
combine in one pass) runs its plain version here (``kernel_mode="ref"``)
and is held against the jitted reference's own chain for the same level:
``repro.core.algorithms``' SIA, RE-SIA or TC-SIA level body
(``_lane_sparsifier_state`` → ``kops.sparsify_ef_level`` →
``kops.chain_accum_level``), whose τ search is replaced by the given τ in
the threshold form. The port's whole level step of each kind, the
dispatch rule's boundary (d = 49,152 takes the resident entry, d = 49,153
and a per-lane ``q_budget`` the two multi-block kernels) and the launch
predictions of ``tests/_torch_launches.py`` are held the same way.

Inputs are numpy arrays from a seed: lanes W ∈ {1, 3, 28} at d ∈ {281,
7850}; the global-mask forms none, lane-shared [d], per-lane [W, d] and
cohort-shared [B, d] (TC-SIA; SIA and RE-SIA read none), and one with
values other than 0 and 1 (NaN among them); ``ref.resident_edge_lanes``'
edge lanes (ties straddling the q-th magnitude, NaN and ±inf, all zeros,
p = 0, valid = 0) with γ_in = −0.0 on a lane of zeros and among the zeros
of lane 0; q ≤ 0, q = 11, q = d and q > d; given τ per lane from the
operand's magnitudes with 0, +inf and a NaN τ (on the lane that holds
NaN and ±inf).

Tolerance: none. Outputs and integers are compared bit for bit
(``view(int32)``), a NaN equal to any NaN; ``err_sq`` is the pinned fold
under ``err_sq_mode="kernel"`` (bit for bit) and a row sum under
``"jnp"`` (rtol 1e-6, as in the other files).
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
from repro_torch.core import algorithms as talg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_launches import RESIDENT_D, level_launches

torch.set_num_threads(1)

KINDS = ["sia", "re_sia", "tc_sia"]
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
    """The edge lanes (γ_in = −0.0 on the all-zeros lane 3 where W ≥ 7),
    with γ_in = −0.0 on half of lane 0's zeros of γ_in too."""
    x = {k: v.numpy().copy() for k, v in
         tref.resident_edge_lanes(w, d, seed).items()}
    zeros = np.flatnonzero(x["gin"][0] == 0)
    x["gin"][0, zeros[::2]] = -0.0
    return x


def _gmask(form, w, d, seed, cohorts=0):
    m = tref.resident_gmask(form, w, d, seed, cohorts)
    return None if m is None else m.numpy()


def _taus(x, gm, cohorts, q, variant):
    """[W] given τ (``ref.resident_taus``); W = 1 a NaN τ in the second
    variant."""
    tau = tref.resident_taus({k: _t(v) for k, v in x.items()}, _t(gm),
                             cohorts, q).numpy()
    if tau.shape[0] == 1 and variant:
        tau[0] = np.nan
    return tau


def _jcfg(kind, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jalg.AggConfig(kind=kind, kernel_mode="ref", **kw)


def _tcfg(kind, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return talg.AggConfig(kind=kind, kernel_mode="ref", **kw)


def _budget(kind, q):
    """The config fields that give ``kind`` the local budget q (TC-SIA's
    q_local; q_global only keeps the paper's split from being applied)."""
    return dict(q=q, q_local=q, q_global=1) if kind == "tc_sia" else dict(
        q=q)


# ---------------------------------------------------------------------------
# the plain version against the reference's chain
# ---------------------------------------------------------------------------

# (W, d, global mask form of TC-SIA, cohorts)
CASES = [(1, 281, None, 0), (3, 281, "shared", 0), (3, 281, "lanes", 0),
         (28, 281, "cohort", 4), (28, 7850, None, 0), (1, 7850, "shared", 0),
         (28, 7850, "lanes", 0), (3, 7850, "cohort", 3), (28, 281, "odd", 0)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("kind", KINDS)
def test_ia_fuse_select_matches_reference(kind, case):
    """γ_out, e′, nnz, nnz_off and the pinned ‖e′‖² of the plain resident
    step = the reference's level body of ``kind`` (exact Top-Q for q ≤ 0,
    q = 11, q = d and q > d; given τ), with and without the error."""
    w, d, form, cohorts = case
    x = _lanes(w, d, seed=5 * w + d)
    gm = _gmask(form, w, d, seed=w, cohorts=cohorts) if kind == "tc_sia" \
        else None
    qs = (0, 11, d, d + 3)
    taus = [_taus(x, gm, cohorts, 11, v) for v in range(1 + (w == 1))]
    # the reference's body reads a mask array; "none" is zeros there
    jgm = np.zeros((d,), np.float32) if gm is None else gm
    body = jalg._FUSED_LEVEL[jalg.AggKind(kind)]

    def reference(g, e, gin, wv, p, valid, m, taus):
        outs = []
        for q in qs:
            cfg = _jcfg(kind, err_sq_mode="kernel", **_budget(kind, q))
            outs.append(body(cfg, g, gin, e, wv, p, m, None, valid,
                             cohorts))
        orig = jsp.threshold_for_topq
        try:
            for tau in taus:
                jsp.threshold_for_topq = lambda *a, _t=tau, **k: _t
                cfg = _jcfg(kind, err_sq_mode="kernel", topq_impl="threshold",
                            **_budget(kind, 11))
                outs.append(body(cfg, g, gin, e, wv, p, m, None, valid,
                                 cohorts))
        finally:
            jsp.threshold_for_topq = orig
        return outs

    want = jax.jit(reference)(x["g"], x["e"], x["gin"], x["w"], x["p"],
                              x["valid"], jgm, taus)
    args = tuple(map(_t, (x["g"], x["e"], x["gin"], x["w"], x["p"],
                          x["valid"], gm)))
    forms = [dict(q=q) for q in qs] + [dict(tau=_t(t)) for t in taus]
    for form_kw, (gout, e_new, stats) in zip(forms, want):
        for err in (False, True):
            got = tops.ia_fuse_select_level(
                *args, kind=kind, gmask_cohorts=cohorts, with_err=err,
                mode="ref", **form_kw)
            assert len(got) == 4 + err
            msg = f"{kind} {form_kw} with_err={err}"
            _same(gout, got[0], f"γ {msg}")
            _same(e_new, got[1], f"e′ {msg}")
            _same(stats.nnz_out, got[2], f"nnz {msg}")
            _same(stats.nnz_local, got[3], f"nnz_off {msg}")
            if err:
                _same(stats.err_sq, got[4], f"err {msg}")


def test_ia_fuse_select_refuses_bad_calls():
    """A kind outside the SIA family, a global mask for SIA or RE-SIA, or
    q and τ both or neither raise on the plain version and the wrapper;
    a CPU tensor under ``"always"`` raises."""
    from repro_torch.kernels import level
    z, one = torch.zeros((1, 8)), torch.ones(1)
    args = (z, z, z, one, one, one)
    for bad in (dict(kind="cl_sia", q=2), dict(kind="sia", q=2, gmask=z[0]),
                dict(kind="re_sia", q=2, tau=one), dict(kind="tc_sia")):
        with pytest.raises(ValueError):
            tops.ia_fuse_select_level(*args, mode="ref", **bad)
    with pytest.raises(RuntimeError):
        tops.ia_fuse_select_level(*args, kind="sia", q=2, mode="always")
    with pytest.raises(ValueError):
        level.ia_fuse_select_level_cuda(*args, kind="sia", q=2)
    assert level.ia_fuse_select_level_cuda in level.KERNELS
    for kind in talg.AggKind:
        if kind.value in tref.IA_KINDS:
            assert tref.ia_kind(kind, None, 2, None) == kind.value


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


PLAIN = ("ref_ia_fuse_select_level", "ref_sparsify_ef_level",
         "ref_chain_accum_level", "ref_tau_search_fused_level",
         "ref_count_ge_fused_level", "ref_hist_topq_level",
         "ref_cl_fuse_select_level", "ref_cl_fuse_level")

# (kind, topq_impl, tau_impl, W, d, global mask form, err_sq_mode)
STEP_CASES = [("sia", "exact", "scan", 28, 7850, None, "kernel"),
              ("sia", "threshold", "scan", 1, 7850, None, "jnp"),
              ("re_sia", "exact", "scan", 3, 281, "shared", "jnp"),
              ("re_sia", "threshold", "hist", 28, 7850, None, "kernel"),
              ("tc_sia", "exact", "scan", 28, 7850, "lanes", "kernel"),
              ("tc_sia", "exact", "scan", 1, 7850, "shared", "jnp"),
              ("tc_sia", "threshold", "scan", 28, 281, "lanes", "kernel"),
              ("tc_sia", "threshold", "hist", 3, 7850, "shared", "jnp")]


@pytest.fixture
def pallas_counts(monkeypatch):
    """The reference's fused-operand counts as its Pallas kernel computes
    them (see ``test_torch_resident_level.py``)."""
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    def counts(g, e, gamma_in, weight, participate, taus, gmask=None, *,
               include_gamma=False, gmask_cohorts=0, mode="auto"):
        op = jref.fused_operand(g, e, gamma_in, weight, participate, gmask,
                                include_gamma=include_gamma,
                                gmask_cohorts=gmask_cohorts)
        return jsp.count_ge_batch(jnp.abs(op), taus)
    monkeypatch.setattr(jops, "count_ge_fused_level", counts)


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_ia_level_step_matches_reference(case, pallas_counts, monkeypatch):
    """One resident level of SIA, RE-SIA and TC-SIA = the reference's
    jitted level step (aggregate, EF rows, nnz, bits, ``err_sq``), through
    one ``ia_fuse_select_level`` (and the τ search) and neither kernel of
    the multi-block chain nor a CL form."""
    kind, impl, tau_impl, w, d, form, err_mode = case
    x = _lanes(w, d, seed=7 * w + d)
    gm = _gmask(form, w, d, seed=d)
    if gm is None:
        gm = np.zeros((d,), np.float32)
    kw = dict(q=11, topq_impl=impl, tau_impl=tau_impl, hist_branch=BRANCH,
              hist_rounds=ROUNDS if tau_impl == "scan" else 2,
              err_sq_mode=err_mode)
    want = jax.jit(jalg.level_step(_jcfg(kind, **kw)))(
        x["g"], x["gin"], x["e"], x["w"], x["p"], gm, None, x["valid"])
    calls = _counting(monkeypatch, *PLAIN)
    cfg = _tcfg(kind, **kw)
    got = talg.level_step(cfg)(
        *map(_t, (x["g"], x["gin"], x["e"], x["w"], x["p"], gm)), None,
        _t(x["valid"]))
    assert {k.removeprefix("ref_"): v for k, v in calls.items() if v} == \
        level_launches(cfg, d), calls
    _same(want[0], got[0], "aggregate")
    _same(want[1], got[1], "e_new")
    for name in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same(getattr(want[2], name), getattr(got[2], name), name)
    if err_mode == "kernel":
        _same(want[2].err_sq, got[2].err_sq, "err_sq")
    else:
        np.testing.assert_allclose(np.asarray(want[2].err_sq),
                                   got[2].err_sq.numpy(), rtol=ERR_RTOL)


@pytest.mark.parametrize("impl", ["exact", "threshold"])
def test_tc_sia_cohort_level_step_matches_reference(impl, pallas_counts):
    """Three cohorts of a W = 2 TC-SIA level with a cohort-shared [B, d]
    mask (``level_step_batched``) = the reference's batched level step."""
    b, w, d = 3, 2, 281
    x = _lanes(b * w, d, seed=11)
    x = {k: v.reshape((b, w) + v.shape[1:]) for k, v in x.items()}
    gm = _gmask("cohort", w, d, seed=11, cohorts=b)
    kw = dict(q=11, topq_impl=impl, hist_branch=BRANCH, hist_rounds=ROUNDS,
              err_sq_mode="kernel")
    want = jax.jit(jalg.level_step_batched(_jcfg("tc_sia", **kw)))(
        x["g"], x["gin"], x["e"], x["w"], x["p"], gm, None, x["valid"])
    got = talg.level_step_batched(_tcfg("tc_sia", **kw))(
        *map(_t, (x["g"], x["gin"], x["e"], x["w"], x["p"], gm)), None,
        _t(x["valid"]))
    _same(want[0], got[0], "aggregate")
    _same(want[1], got[1], "e_new")
    for name in ("nnz_out", "nnz_global", "nnz_local", "bits", "err_sq"):
        _same(getattr(want[2], name), getattr(got[2], name), name)


# ---------------------------------------------------------------------------
# the dispatch rule and the launch predictions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_ia_dispatch_rule_boundary(kind, monkeypatch):
    """d = 49,152 takes ``ia_fuse_select_level``; d = 49,153, and a
    per-lane ``q_budget`` at any d, the multi-block chain
    (``sparsify_ef_level`` then ``chain_accum_level``). Every form gives
    the unfused bodies' numbers."""
    top = tops.RESIDENT_MAX_D
    assert top == RESIDENT_D
    for d, budget in ((top, False), (top + 1, False), (281, True)):
        x = _lanes(1, d, seed=d)
        gm = np.zeros((d,), np.float32)
        gm[:: 17] = 1.0
        qb = torch.tensor([40], dtype=torch.int32) if budget else None
        args = tuple(map(_t, (x["g"], x["gin"], x["e"], x["w"], x["p"],
                              gm)))
        for impl in ("exact", "threshold"):
            cfg = _tcfg(kind, q=78, topq_impl=impl, hist_branch=BRANCH,
                        hist_rounds=ROUNDS)
            calls = _counting(monkeypatch, *PLAIN)
            got = talg.level_step(cfg)(*args, qb)
            monkeypatch.undo()
            resident = d <= top and not budget
            grown = {k.removeprefix("ref_"): v for k, v in calls.items()
                     if v}
            assert grown == level_launches(cfg, d, budgets=budget), (
                d, impl, grown)
            assert ("ia_fuse_select_level" in grown) == resident
            assert ("sparsify_ef_level" in grown) == (not resident)
            want = talg.level_step(dataclasses.replace(
                cfg, kernel_mode="never"))(*args, qb)
            for u, v in zip(want[:2] + tuple(want[2][:4]),
                            got[:2] + tuple(got[2][:4])):
                assert torch.equal(u, v), (d, impl, budget)


# (kind, topq_impl, tau_impl, d, budgets) → the launches of two levels
LAUNCHES = [
    ("sia", "exact", "scan", 281, False, {"ia_fuse_select_level": 2}),
    ("re_sia", "threshold", "scan", 281, False,
     {"ia_fuse_select_level": 2, "tau_search_fused_level": 2}),
    ("tc_sia", "threshold", "hist", 7850, False,
     {"ia_fuse_select_level": 2, "hist_topq_level": 2}),
    ("tc_sia", "exact", "scan", 281, True,
     {"sparsify_ef_level": 2, "chain_accum_level": 2}),
    ("sia", "threshold", "scan", 281, True,
     {"sparsify_ef_level": 2, "chain_accum_level": 2}),
    ("re_sia", "exact", "scan", 49_153, False,
     {"sparsify_ef_level": 2, "chain_accum_level": 2}),
    ("sia", "threshold", "scan", 49_153, False,
     {"sparsify_ef_level": 2, "chain_accum_level": 2,
      "count_ge_fused_level": 6}),
    ("cl_sia", "exact", "scan", 281, False, {"cl_fuse_select_level": 2}),
    ("cl_tc_sia", "threshold", "scan", 281, True, {"cl_fuse_level": 2}),
    ("cl_sia", "threshold", "hist", 49_153, False,
     {"cl_fuse_level": 2, "hist_topq_level": 2}),
]


@pytest.mark.parametrize("case", LAUNCHES,
                         ids=lambda c: "-".join(map(str, c[:5])))
def test_level_launches_are_the_plain_calls(case, monkeypatch):
    """``level_launches`` states each literal dict, and one level step on
    the CPU calls the plain versions of the kernels it predicts, each as
    often as predicted (a budgeted level runs no τ search)."""
    kind, impl, tau_impl, d, budgets, launches = case
    cfg = _tcfg(kind, q=78, topq_impl=impl, tau_impl=tau_impl,
                hist_branch=BRANCH,
                hist_rounds=ROUNDS if tau_impl == "scan" else 2)
    assert level_launches(cfg, d, 2, budgets=budgets) == launches
    x = _lanes(1, d, seed=3)
    qb = torch.tensor([40], dtype=torch.int32) if budgets else None
    calls = _counting(monkeypatch, *PLAIN)
    talg.level_step(cfg)(*map(_t, (x["g"], x["gin"], x["e"], x["w"],
                                   x["p"], np.zeros((d,), np.float32))), qb)
    assert {k.removeprefix("ref_"): 2 * v for k, v in calls.items() if v} \
        == launches
