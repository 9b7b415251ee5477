"""Attention: GQA/MQA with RoPE; full, blocked, SWA, decode.

The reference's plain implementations, with its materialized float32
scores (plain einsums, no fused attention): q·scale, k and v are upcast to
f32, masked scores are ``NEG_INF = -1e30`` and the output is cast back to
q's dtype. The reference's GSPMD sharding constraints (``_mesh_auto``,
``_head_axes``, ``_batch_ax``, ``_constrain_scores``) pin shardings on a
mesh and are the identity on one process, so they have no counterpart.

Caches are updated in place: a K/V cache passed to :func:`run_attention`
is consumed (its slot or prefix is overwritten) and returned.
:func:`run_attention_tp` is the training sub-layer split over a client's
ranks (:mod:`repro_torch.models.tp`) by heads, or by query sequence where
the heads do not divide them, and with a cache site the serving one;
:func:`decode_partial` and :func:`combine_partials` are decode split over
blocks of cache slots (split-K, :mod:`repro_torch.models.serve_split`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def _split_gqa(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """[B, S, Hq, Dh] → [B, S, Hkv, G, Dh]."""
    b, s, hq, dh = q.shape
    return q.reshape(b, s, num_kv, hq // num_kv, dh)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Materialized-scores attention (used for S ≤ ~4k and as the oracle).

    q: [B, Sq, Hq, Dh]; k,v: [B, Sk, Hkv, Dh]. ``q_offset``/``k_offset``
    are the absolute positions of q[0]/k[0] (cached decoding, chunked
    prefill, SWA-sliced K spans).
    """
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    qg = _split_gqa(q, hkv)
    scale = dh ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float() * scale, k.float())
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = k_offset + torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 1024, k_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Q-blocked attention: a loop over query chunks, each attending to the
    full K/V with materialized [qc × Sk] scores (O(qc·Sk) memory); with a
    window each chunk scores only the last ``window + q_chunk`` keys.

    Matches :func:`plain_attention` to f32 accuracy. ``k_chunk`` is
    accepted for API compatibility.
    """
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    nq = sq // q_chunk
    span = window + q_chunk if window > 0 else sk
    span = min(span, sk)
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_off = q_offset + qi * q_chunk
        if span < sk:
            start = min(max(q_off + q_chunk - span, 0), sk - span)
            out = plain_attention(qblk, k[:, start:start + span],
                                  v[:, start:start + span], causal=causal,
                                  window=window, q_offset=q_off,
                                  k_offset=start)
        else:
            out = plain_attention(qblk, k, v, causal=causal, window=window,
                                  q_offset=q_off)
        outs.append(out)
    return torch.cat(outs, dim=1).reshape(b, sq, hq, dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *, window: int = 0,
                     ring: bool = False) -> torch.Tensor:
    """One-token attention against a cache.

    q: [B, 1, Hq, Dh]; caches: [B, Smax, Hkv, Dh]; ``pos``: current absolute
    position (a Python int). Plain cache: entries at index ≤ pos are valid.
    Ring cache (``ring=True``): slot j holds absolute position
    pos − ((pos − j) mod Smax); valid iff j ≤ pos (warmup) — window bound is
    implicit.
    """
    b, _, hq, dh = q.shape
    _, smax, hkv, _ = k_cache.shape
    qg = _split_gqa(q, hkv).float() * dh ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float())
    kpos = torch.arange(smax, device=q.device)
    valid = kpos <= pos
    if window > 0 and not ring:
        valid &= kpos > pos - window
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lo: int, pos: int, smax: int, *, window: int = 0,
                   ring: bool = False) -> tuple:
    """:func:`decode_attention` over one block of cache slots
    ``[lo, lo + w)`` (split-K decode): q ``[B, 1, Hq, Dh]``, the block's
    k, v ``[B, w, Hkv, Dh]`` → float32 ``(max [B, Hkv, G, 1], Σ exp
    [B, Hkv, G, 1], Σ exp·v [B, 1, Hkv, G, Dh])`` over the slots valid at
    ``pos`` under :func:`decode_attention`'s masks (slots past ``smax`` are
    padding). An all-masked block gives max ``NEG_INF`` and zero sums: a
    masked slot adds 0, not ``exp(0)``."""
    _, w, hkv, _ = k.shape
    dh = q.shape[-1]
    qg = _split_gqa(q, hkv).float() * dh ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    kpos = lo + torch.arange(w, device=q.device)
    valid = (kpos <= pos) & (kpos < smax)
    if window > 0 and not ring:
        valid &= kpos > pos - window
    s = torch.where(valid, s, NEG_INF)
    top = s.amax(-1)
    p = torch.where(valid, torch.exp(s - top[..., None]), 0.0)
    return top, p.sum(-1), torch.einsum("bkgqs,bskd->bqkgd", p, v.float())


def _rescale(top: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """A block's weight ``exp(max_r − max)`` in the combined softmax."""
    return torch.exp(top - total)


def combine_partials(parts: list, device, dtype: torch.dtype
                     ) -> torch.Tensor:
    """The attention of one query from its blocks' :func:`decode_partial`
    pieces → ``[B, 1, Hq, Dh]`` in ``dtype`` on ``device``. Each piece is
    rescaled by ``exp(max_r − max)`` where it lies, and the sums and
    weighted values are added in float32 in ``pair_sum``'s fixed order."""
    from repro_torch.device import to_device
    from repro_torch.models.tp import pair_sum
    total = parts[0][0]
    for top, _, _ in parts[1:]:
        total = torch.maximum(total, to_device(top, total.device))
    sums, vals = [], []
    for top, l, acc in parts:
        w = _rescale(top, to_device(total, top.device))
        sums.append(l * w)
        vals.append(acc * w.permute(0, 3, 1, 2)[..., None])
    out = pair_sum(vals) / to_device(pair_sum(sums), vals[0].device
                                     ).permute(0, 3, 1, 2)[..., None]
    b, q, hkv, g, dh = out.shape
    return to_device(out.reshape(b, q, hkv * g, dh).to(dtype),
                     torch.device(device))


# ---------------------------------------------------------------------------
# Full attention sub-layer (projections + RoPE + cache plumbing)
# ---------------------------------------------------------------------------

def _project(x: torch.Tensor, w: torch.Tensor, bias, heads: int,
             head_dim: int, positions, rope_theta: float) -> torch.Tensor:
    """One of ``attn_project_qkv``'s projections, ``[B, S, heads, Dh]``;
    RoPE applied unless ``positions`` is ``None`` (v)."""
    b, s, _ = x.shape
    y = x @ w
    if bias is not None:
        y = y + bias
    y = y.reshape(b, s, heads, head_dim)
    return y if positions is None else apply_rope(y, positions, rope_theta)


def attn_project_qkv(params, x: torch.Tensor, *, num_heads: int,
                     num_kv: int, head_dim: int, rope_theta: float,
                     positions: torch.Tensor):
    """x: [B, S, D] → q [B,S,Hq,Dh], k,v [B,S,Hkv,Dh], RoPE applied."""
    q = _project(x, params["wq"], params.get("bq"), num_heads, head_dim,
                 positions, rope_theta)
    k = _project(x, params["wk"], params.get("bk"), num_kv, head_dim,
                 positions, rope_theta)
    v = _project(x, params["wv"], params.get("bv"), num_kv, head_dim, None,
                 rope_theta)
    return q, k, v


def attn_out(params, o: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = o.shape
    return o.reshape(b, s, h * dh) @ params["wo"]


def run_attention(params, x: torch.Tensor, *, cfg_heads: int, cfg_kv: int,
                  head_dim: int, rope_theta: float, window: int,
                  cache: Optional[dict] = None, pos: Optional[int] = None,
                  blocked_threshold: int = 8192, q_chunk: int = 1024,
                  k_chunk: int = 1024):
    """Full attention sub-layer.

    Modes:
    * train/prefill: ``pos is None`` → causal self-attention over x; with a
      cache dict its K/V are seeded (prefill), in place.
    * decode: ``cache`` + ``pos`` (a Python int) → one-token step; the new
      K/V are written into the cache in place.

    Returns (out [B,S,D], cache_or_None): the cache passed in, updated.
    """
    b, s, _ = x.shape
    if pos is None:
        positions = torch.arange(s, device=x.device)[None, :]
    else:
        positions = torch.full((b, s), pos, device=x.device)
    q, k, v = attn_project_qkv(
        params, x, num_heads=cfg_heads, num_kv=cfg_kv, head_dim=head_dim,
        rope_theta=rope_theta, positions=positions)

    if cache is not None and pos is not None:
        # decode step. SWA caches are ring buffers of length == window:
        # slot = pos % smax; validity slot_pos <= pos covers both the warmup
        # and the steady state, and the window bound is implicit for ring
        # buffers (only the last `window` tokens are retained).
        smax = cache["k"].shape[1]
        slot = pos % smax
        cache["k"][:, slot:slot + s] = k
        cache["v"][:, slot:slot + s] = v
        eff_window = window if (window == 0 or smax > window) else 0
        o = decode_attention(q, cache["k"], cache["v"], pos,
                             window=eff_window,
                             ring=smax <= max(window, 0) and window > 0)
        return attn_out(params, o), cache

    if s >= blocked_threshold:
        o = blocked_attention(q, k, v, causal=True, window=window,
                              q_chunk=q_chunk, k_chunk=k_chunk)
    else:
        o = plain_attention(q, k, v, causal=True, window=window)
    if cache is not None:
        smax = cache["k"].shape[1]
        if smax < s:
            # SWA ring cache shorter than the prompt: keep the last smax
            # tokens; slot alignment requires s % smax == 0 (configs comply).
            assert s % smax == 0, (s, smax)
            cache["k"].copy_(k[:, -smax:])
            cache["v"].copy_(v[:, -smax:])
        else:
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
    return attn_out(params, o), cache


def _kv_heads(m: int, hq_local: int, group: int, device) -> torch.Tensor:
    """The kv heads rank m's q heads ``[m·hq_local, (m+1)·hq_local)`` use,
    in an order that keeps ``_split_gqa``'s grouping: a contiguous run
    where the q heads cover whole groups or sit in one, else one kv head
    per q head (groups of one)."""
    lo = m * hq_local
    if hq_local % group == 0:
        return torch.arange(lo // group, (lo + hq_local) // group,
                            device=device)
    if group % hq_local == 0:
        return torch.arange(lo // group, lo // group + 1, device=device)
    return torch.arange(lo, lo + hq_local, device=device) // group


def query_blocks(m: int, cfg_heads: int, s: int,
                 blocked_threshold: int) -> int:
    """How many query-sequence blocks :func:`run_attention_tp` splits a
    sub-layer of ``s`` tokens into over a client's ``m`` ranks: ``m`` where
    the q heads do not divide it (so neither the kv heads nor the group
    does), it divides ``s`` and the scores are materialized (``s <
    blocked_threshold``) — the reference's ``_constrain_scores`` rule,
    which pins the scores' query dim to ``model`` there — else 1 (heads
    split, or the whole form)."""
    if m > 1 and cfg_heads % m and not s % m and s < blocked_threshold:
        return m
    return 1


def run_attention_tp(ps: list, x: torch.Tensor, tp, *, cfg_heads: int,
                     cfg_kv: int, head_dim: int, rope_theta: float,
                     window: int, blocked_threshold: int = 8192,
                     q_chunk: int = 1024, k_chunk: int = 1024,
                     cache=None) -> torch.Tensor:
    """The sub-layer split over ``tp``'s ranks: ``ps[m]`` is rank m's
    attention tree, ``x`` the replicated input on rank 0's device → the
    output there.

    Where the q heads divide the ranks: column-parallel ``wq/wk/wv`` (and
    biases) by heads, the attention of each rank's heads on its device,
    row-parallel ``wo`` summed over the ranks. Where the kv heads do not
    divide (``param_pspecs`` replicates ``wk/wv``), k and v are projected
    once on rank 0's device and each rank takes the kv heads its q heads
    use.

    Where the q heads do not divide, :func:`query_blocks` decides. Split
    by query sequence, rank m takes query rows ``[m·s/M, (m+1)·s/M)``: it
    projects them with the whole (replicated) ``wq``, attends to the whole
    k/v — projected once on rank 0's device and copied to every rank — and
    applies the whole ``wo``; the blocks' outputs are concatenated on rank
    0's device. The weights reach the ranks through :meth:`TP.scatter`, so
    their gradient is the ranks' partials summed on rank 0 in float32.
    Otherwise (``s`` not a multiple of M, the blocked path, a decode) the
    sub-layer runs whole on rank 0's device.

    Without ``cache`` it is the training form (causal, no cache). With one
    (a serving split's cache site, :mod:`repro_torch.models.serve_split`)
    the fresh k/v go to ``cache.write(kvs, s)`` — one (k, v) a rank where
    the kv heads split, else one of all heads on rank 0's device — and
    where ``cache.pos`` is a host int (a decode; the positions are
    ``pos``) the heads attend through ``cache.attend(qs)`` over the cached
    blocks; a prefill attends to the fresh k/v as training does."""
    from repro_torch.models.tp import check_shape
    q_ok, hq = tp.split(cfg_heads)
    b, s, d = x.shape
    if query_blocks(tp.m, cfg_heads, s, blocked_threshold) > 1:
        return _by_query_blocks(ps[0], x, tp, cfg_heads=cfg_heads,
                                cfg_kv=cfg_kv, head_dim=head_dim,
                                rope_theta=rope_theta, window=window,
                                cache=cache)
    if not q_ok and cache is None:
        return run_attention(ps[0], x, cfg_heads=cfg_heads, cfg_kv=cfg_kv,
                             head_dim=head_dim, rope_theta=rope_theta,
                             window=window,
                             blocked_threshold=blocked_threshold,
                             q_chunk=q_chunk, k_chunk=k_chunk)[0]
    kv_ok, hkv = tp.split(cfg_kv)
    pos = None if cache is None else cache.pos

    def positions(dev):
        if pos is None:
            return torch.arange(s, device=dev)[None, :]
        return torch.full((b, s), pos, device=dev)

    # where the q heads do not divide, one rank of all heads
    ranks = list(zip(ps, tp.scatter(x))) if q_ok else [(ps[0], x)]
    split_kv = q_ok and kv_ok
    kvs = [] if split_kv else [(
        _project(x, ps[0]["wk"], ps[0].get("bk"), cfg_kv, head_dim,
                 positions(x.device), rope_theta),
        _project(x, ps[0]["wv"], ps[0].get("bv"), cfg_kv, head_dim, None,
                 rope_theta))]
    qs = []
    for p, xm in ranks:
        check_shape(p["wq"], (d, hq * head_dim), "wq")
        check_shape(p["wo"], (hq * head_dim, d), "wo")
        qs.append(_project(xm, p["wq"], p.get("bq"), hq, head_dim,
                           positions(xm.device), rope_theta))
        if split_kv:
            check_shape(p["wk"], (d, hkv * head_dim), "wk")
            kvs.append((_project(xm, p["wk"], p.get("bk"), hkv, head_dim,
                                 positions(xm.device), rope_theta),
                        _project(xm, p["wv"], p.get("bv"), hkv, head_dim,
                                 None, rope_theta)))
    if cache is not None:
        cache.write(kvs, s)
    if pos is not None:
        outs = cache.attend(qs)
    else:
        if len(kvs) < len(qs):
            ks, vs = tp.scatter(kvs[0][0]), tp.scatter(kvs[0][1])
            kvs = [(k.index_select(2, idx), v.index_select(2, idx))
                   for m, (k, v) in enumerate(zip(ks, vs))
                   for idx in [_kv_heads(m, hq, cfg_heads // cfg_kv,
                                         k.device)]]
        outs = []
        for q, (k, v) in zip(qs, kvs):
            if s >= blocked_threshold:
                outs.append(blocked_attention(
                    q, k, v, causal=True, window=window, q_chunk=q_chunk,
                    k_chunk=k_chunk))
            else:
                outs.append(plain_attention(q, k, v, causal=True,
                                            window=window))
    parts = [attn_out(p, o) for (p, _), o in zip(ranks, outs)]
    return tp.reduce(parts) if len(parts) > 1 else parts[0]


def _by_query_blocks(p: dict, x: torch.Tensor, tp, *, cfg_heads: int,
                     cfg_kv: int, head_dim: int, rope_theta: float,
                     window: int, cache=None) -> torch.Tensor:
    """:func:`run_attention_tp` split by query sequence, block m on rank m
    (``p`` rank 0's tree, its weights whole)."""
    from repro_torch.device import to_device
    from repro_torch.models.tp import check_shape
    b, s, d = x.shape
    rows = s // tp.m
    check_shape(p["wq"], (d, cfg_heads * head_dim), "wq")
    check_shape(p["wo"], (cfg_heads * head_dim, d), "wo")
    k = _project(x, p["wk"], p.get("bk"), cfg_kv, head_dim,
                 torch.arange(s, device=x.device)[None, :], rope_theta)
    v = _project(x, p["wv"], p.get("bv"), cfg_kv, head_dim, None, rope_theta)
    if cache is not None:
        cache.write([(k, v)], s)
    ks, vs = tp.scatter(k), tp.scatter(v)
    wqs, wos = tp.scatter(p["wq"]), tp.scatter(p["wo"])
    bqs = tp.scatter(p["bq"]) if "bq" in p else [None] * tp.m
    outs = []
    for m, dev in enumerate(tp.devices):
        lo = m * rows
        xm = to_device(x[:, lo:lo + rows], dev)
        q = _project(xm, wqs[m], bqs[m], cfg_heads, head_dim,
                     torch.arange(lo, lo + rows, device=dev)[None, :],
                     rope_theta)
        o = plain_attention(q, ks[m], vs[m], causal=True, window=window,
                            q_offset=lo)
        outs.append(to_device(attn_out({"wo": wos[m]}, o), tp.home))
    return torch.cat(outs, dim=1)
