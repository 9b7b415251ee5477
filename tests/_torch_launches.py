"""The level-kernel launches the port's fused level steps should make,
stated on their own: the launch gates of the card tests and of
``chip_smoke.py`` hold the wrappers' counters to these numbers and never
ask the port's dispatch code, so a wrong dispatch condition shows as a
count that differs.

The resident forms (``cl_fuse_select_level``, ``ia_fuse_select_level``,
``tau_search_fused_level``) take lanes of at most :data:`RESIDENT_D`
elements and a τ scan of at most :data:`RESIDENT_BRANCH` candidates, the
limits ``kernels/ops.py`` documents; a longer lane takes the multi-block
kernels.
"""

RESIDENT_D = 49_152
RESIDENT_BRANCH = 1_024

_CL = ("cl_sia", "cl_tc_sia")
_FUSED = ("sia", "re_sia", "tc_sia") + _CL


def level_launches(cfg, d: int, levels: int = 1, *,
                   budgets: bool = False) -> dict:
    """Kernel launches of ``levels`` fused level steps under the
    ``AggConfig`` ``cfg`` whose lanes hold d elements, by kernel name.

    Once a level: the CL fuse, or ``sparsify_ef_level`` and
    ``chain_accum_level``; under threshold Top-Q also the τ search, once a
    round where it counts through ``count_ge_fused_level``. On resident
    lanes with a static q (``budgets``, per-node ``q_budget``, keeps the
    sort and the multi-block kernels) exact CL Top-Q is
    ``cl_fuse_select_level`` alone, SIA, RE-SIA and TC-SIA
    ``ia_fuse_select_level`` alone, exact or after the search, and the
    scan ``tau_search_fused_level``. A budgeted level selects by its sort
    under either ``topq_impl`` and searches no τ. Empty where ``cfg``
    takes no fused step."""
    kind = getattr(cfg.kind, "value", cfg.kind)
    if kind not in _FUSED or cfg.kernel_mode == "never" or levels <= 0:
        return {}
    resident = d <= RESIDENT_D
    if kind in _CL:
        select = resident and cfg.topq_impl == "exact" and not budgets
        out = {"cl_fuse_select_level" if select else "cl_fuse_level": levels}
    elif resident and not budgets:
        out = {"ia_fuse_select_level": levels}
    else:
        out = {"sparsify_ef_level": levels, "chain_accum_level": levels}
    if cfg.topq_impl == "threshold" and not budgets:
        if cfg.tau_impl == "hist":
            out["hist_topq_level"] = levels
        elif resident and cfg.hist_branch <= RESIDENT_BRANCH:
            out["tau_search_fused_level"] = levels
        else:
            out["count_ge_fused_level"] = levels * cfg.hist_rounds
    return out


def train_launches(step) -> dict:
    """Level-kernel launches of one train step's phase 2 on a mesh of card
    ranks: per model column (every cohort at once) one level step per level
    of the plan, each stage at its lanes' width (the column's segment; a
    nested stage s the 1 / prod(sizes[:s+1]) share of the column)."""
    if step.nested is None:
        parts = [(step.plan.shape[0], step.seg)]
    else:
        n, parts = step.layout.n_local, []
        for stage, size in zip(step.nested.stages, step.sizes):
            n //= size
            parts.append((stage.shape[0], n))
    out = {}
    for levels, width in parts:
        for name, c in level_launches(step.agg_cfg, width,
                                      levels * step.m).items():
            out[name] = out.get(name, 0) + c
    return out
