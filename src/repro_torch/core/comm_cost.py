"""Communication-cost models (paper §V) — host-side closed forms (port of
:mod:`repro.core.comm_cost`: the flat and tree forms).

These are the analytical curves the paper plots in Fig. 2; the simulator's
measured per-hop ``HopStats.bits`` must match them (tests assert it for the
deterministic algorithms and bound the stochastic ones by Prop. 2).

All functions return **bits per global iteration** for the aggregation
(uplink) phase, as Python floats.
"""

from __future__ import annotations

import math


def idx_bits(d: int) -> int:
    """⌈log₂ d⌉."""
    return max(1, math.ceil(math.log2(d)))


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def routing_dense_bits(K: int, d: int, omega: int = 32) -> float:
    """Conventional routing, no sparsification: (K²+K)/2 dense
    transmissions."""
    return (K * K + K) / 2 * d * omega


def routing_sparse_bits(K: int, d: int, q: int, omega: int = 32) -> float:
    """Conventional routing of per-client Top-Q gradients.

    Client k's packet (q nonzeros, value+index each) traverses k links.
    """
    return (K * K + K) / 2 * q * (omega + idx_bits(d))


def dense_ia_bits(K: int, d: int, omega: int = 32) -> float:
    """IA without sparsification: K dense transmissions (Fig 2b upper ref)."""
    return K * d * omega


# ---------------------------------------------------------------------------
# Paper algorithms
# ---------------------------------------------------------------------------

def cl_sia_bits(K: int, d: int, q: int, omega: int = 32) -> float:
    """Alg 3: exactly Q (value+index) per hop → K·Q·(ω+⌈log₂d⌉)."""
    return K * q * (omega + idx_bits(d))


def cl_tc_sia_bits(K: int, d: int, q_global: int, q_local: int,
                   omega: int = 32) -> float:
    """Alg 5: K·ω·Q_G + K·Q_L·(ω+⌈log₂d⌉)  (§V, E‖Λ_k‖₀ = Q_L)."""
    return K * omega * q_global + K * q_local * (omega + idx_bits(d))


def expected_lambda_nnz_bound(K: int, d: int, q_global: int,
                              q_local: int) -> float:
    """Prop. 2: upper bound on Σ_k E‖Λ_k‖₀ for Alg 4 (TC-SIA).

    With Q_G=0, Q_L=Q this also bounds SIA/RE-SIA total nnz (they are
    cost-equivalent to Alg 4 with that setting, §V).
    """
    if q_local <= 0:
        return 0.0
    dp = d - q_global          # Λ lives in the off-mask coordinates
    if dp <= 0:
        return 0.0
    p = 1.0 - q_local / dp
    return dp * (K + 1 - (dp / q_local) * (1.0 - p ** (K + 1)))


def tc_sia_bits_bound(K: int, d: int, q_global: int, q_local: int,
                      omega: int = 32) -> float:
    """Eq. (7) with Prop. 2 plugged in: upper bound for Alg 4."""
    return (K * omega * q_global
            + (omega + idx_bits(d)) * expected_lambda_nnz_bound(
                K, d, q_global, q_local))


def sia_bits_bound(K: int, d: int, q: int, omega: int = 32) -> float:
    """Upper bound for Alg 1/2 (= Alg 4 with Q_G = 0, Q_L = Q)."""
    return tc_sia_bits_bound(K, d, 0, q, omega)


def sia_bits_worst_case(K: int, d: int, q: int, omega: int = 32) -> float:
    """Deterministic worst case for Alg 1/2: ‖γ_k‖₀ = min(d, (K−k+1)·Q)."""
    total_nnz = sum(min(d, j * q) for j in range(1, K + 1))
    return total_nnz * (omega + idx_bits(d))


# ---------------------------------------------------------------------------
# Tree generalizations (repro_torch.topo) — the chain forms are the special
# case of a path graph, where depths = (1..K) and subtree sizes = (1..K).
# ---------------------------------------------------------------------------

def routing_dense_bits_tree(depths, d: int, omega: int = 32) -> float:
    """Conventional routing on a tree: client k's dense packet traverses
    ``depths[k]`` links to the PS → Σ_k depth_k · d·ω.

    On a path graph depths = (1..K) and this reduces to (K²+K)/2·d·ω.
    """
    return float(sum(depths)) * d * omega


def routing_sparse_bits_tree(depths, d: int, q: int, omega: int = 32) -> float:
    """Conventional routing of per-client Top-Q packets on a tree."""
    return float(sum(depths)) * q * (omega + idx_bits(d))


def dense_ia_bits_tree(K: int, d: int, omega: int = 32) -> float:
    """IA without sparsification on *any* tree: every client transmits its
    partial aggregate exactly once over its uplink → K·d·ω, topology
    invariant — the core IA advantage carries over from chains to trees.
    """
    return K * d * omega


def cl_sia_bits_tree(K: int, d: int, q: int, omega: int = 32) -> float:
    """Alg 3 on a tree: every uplink carries exactly Q (value+index) —
    topology invariant like the chain form."""
    return K * q * (omega + idx_bits(d))


def cl_tc_sia_bits_tree(K: int, d: int, q_global: int, q_local: int,
                        omega: int = 32) -> float:
    """Alg 5 on a tree: K·ω·Q_G + K·Q_L·(ω+⌈log₂d⌉), topology invariant."""
    return K * omega * q_global + K * q_local * (omega + idx_bits(d))


def expected_lambda_nnz_bound_tree(subtree_sizes, d: int, q_global: int,
                                   q_local: int) -> float:
    """Tree generalization of Prop. 2: Σ_k E‖Λ_k‖₀ ≤ Σ_k d′·(1 − p^{s_k}).

    ``s_k`` is the subtree size of client k (number of Top-Q_L supports
    unioned into γ_k), d′ = d − Q_G, p = 1 − Q_L/d′ — each of the s_k
    independent supports misses a given off-mask coordinate w.p. p, so
    E‖γ_k‖₀ ≤ d′(1 − p^{s_k}). With path subtree sizes (1..K) this equals
    the chain closed form :func:`expected_lambda_nnz_bound` exactly.
    """
    if q_local <= 0:
        return 0.0
    dp = d - q_global
    if dp <= 0:
        return 0.0
    p = 1.0 - q_local / dp
    return float(sum(dp * (1.0 - p ** int(s)) for s in subtree_sizes))


def tc_sia_bits_bound_tree(subtree_sizes, d: int, q_global: int,
                           q_local: int, omega: int = 32) -> float:
    """Eq. (7) with the tree Prop.-2 bound plugged in (Alg 4 on a tree)."""
    K = len(subtree_sizes)
    return (K * omega * q_global
            + (omega + idx_bits(d)) * expected_lambda_nnz_bound_tree(
                subtree_sizes, d, q_global, q_local))


def sia_bits_worst_case_tree(subtree_sizes, d: int, q: int,
                             omega: int = 32) -> float:
    """Deterministic worst case for Alg 1/2 on a tree:
    ‖γ_k‖₀ ≤ min(d, s_k·Q)."""
    total_nnz = sum(min(d, int(s) * q) for s in subtree_sizes)
    return total_nnz * (omega + idx_bits(d))


# ---------------------------------------------------------------------------
# Normalization used in Fig. 2b
# ---------------------------------------------------------------------------

def single_transmission_bits(d: int, q: int, omega: int = 32,
                             sparse: bool = True) -> float:
    """Size of *one* gradient transmission, the Fig-2b normalizer.

    Sparse algorithms are normalized by one sparse packet (Q value+index
    pairs); dense ones by one dense vector.
    """
    if sparse:
        return q * (omega + idx_bits(d))
    return d * omega


def normalized_efficiency(total_bits: float, d: int, q: int, omega: int = 32,
                          sparse: bool = True) -> float:
    """Total transmitted data in units of single-gradient transmissions."""
    return total_bits / single_transmission_bits(d, q, omega, sparse=sparse)
