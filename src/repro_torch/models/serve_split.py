"""Serving over a mesh: prefill and decode split over the ranks, with the
params placed by ``param_pspecs`` and the cache by ``cache_pspecs`` (the
reference's serving cells, which its dry run shards by those specs).

The port has one controller over local devices (:mod:`repro_torch.models.
tp`). A :class:`ServeSplit` reads the specs once for a mesh, a batch and a
cache length:

* **batch over (pod, data)**, where it divides: DP group k serves requests
  ``[k·B/K, (k+1)·B/K)`` on its M ranks (rank (k, m) on
  ``mesh.devices[k·M + m]``); otherwise one group, on DP rank 0's ranks,
  serves the whole batch;
* **the KV cache**: rank r holds its block of each leaf — its group's
  requests; the kv heads of its column where they divide M; else a block
  of the sequence (of the ring slots, for an SWA cache) over ``model``, or
  over ``data`` where the batch does not divide (split-K decode). Blocks
  are padded as XLA pads (``ceil(n / axis)``), so each rank holds exactly
  ``rank_bytes(cache, cache_pspecs)``; ranks that share a device and a
  block share one tree (:class:`~repro_torch.train.state.RankCache`). SSM
  conv windows and states follow their batch block and are replicated over
  the rest;
* **the compute** of a group runs the training form's layers
  (``transformer._dense_layer_tp``, ``_shared_block_tp``,
  :func:`~repro_torch.models.attention.run_attention_tp`) with a cache
  site of its blocks: q, k, v column-parallel by heads
  (the kv heads replicated where they do not divide: projected once on
  rank (k, 0), each rank taking the kv heads its q heads use), ``wo``
  row-parallel summed by ``TP.reduce`` (f32, ``pair_sum``'s order), the
  MLP and the MoE experts by ``d_ff``, the embedding and the logits by
  vocabulary; a prefill whose q heads do not divide M splits its queries
  by sequence block where ``attention.query_blocks`` says so (its k/v go
  to the cache as one all-heads entry from rank (k, 0)). The replicated
  work — norms, residuals, the router, mamba blocks, a decode's attention
  whose q heads do not divide M — runs once, on rank (k, 0); an SSM
  block's new conv window and state are copied to the ranks that
  replicate them;
* **the cache writes**: prefill writes the prompt's k/v into each block's
  slots (an SWA ring keeps the last ``smax`` positions, with the
  ``s % smax == 0`` rule of the whole form); decode writes the new k/v
  only into the block that owns slot ``pos % smax``, in every copy of it;
* **decode attention** per q head block: each cache block of the group
  gives :func:`~repro_torch.models.attention.decode_partial` on its
  device, and :func:`~repro_torch.models.attention.combine_partials` adds
  the pieces rescaled by ``exp(max_r − max)`` in f32 in ``pair_sum``'s
  order. Prefill attention runs on the fresh k/v, as the whole form's.

An MoE routes in groups of ``min(1024, B·S)`` tokens of the whole batch.
Where a DP group's requests are a whole number of those groups, each DP
group routes its own; elsewhere (a decode, whose one routing group spans
the batch) the layer's inputs are gathered onto group 0's rank 0, routed
once, its experts run on group 0's ranks, and the outputs go back.

The position ``pos`` is a host int; only card-to-card copies are
asynchronous (``device.to_device``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.flat_layout import tree_structure, tree_unflatten
from repro_torch.device import to_device
from repro_torch.models import model as model_mod
from repro_torch.models import partition, transformer
from repro_torch.models.attention import combine_partials, decode_partial
from repro_torch.models.layers import rms_norm
from repro_torch.models.tp import TP
from repro_torch.models.transformer import tree_leaves
from repro_torch.train.state import RankCache
from repro_torch.train.step import _block, shard_params

Tensor = torch.Tensor


def _layers(tree) -> list:
    """A tree stacked on a leading layer axis → each layer's tree (views:
    one ``unbind`` a leaf, not one index a layer and leaf)."""
    if isinstance(tree, dict):
        per = {k: _layers(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(tree.unbind(0))


@dataclasses.dataclass(frozen=True)
class Block:
    """One block of an attention cache site, as a group computes with it:
    sequence block ``s`` (slots from ``lo``, padded past ``smax``) of kv
    head block ``h``; ``home`` is the tree that computes with it,
    ``trees`` every tree that holds a copy (home first)."""

    s: int
    h: int
    lo: int
    home: int
    trees: tuple


class ServeSplit:
    """How a serving cell splits over ``mesh`` for a cache of ``batch``
    requests and ``max_len`` positions (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, mesh, batch: int, max_len: int):
        self.cfg, self.mesh = cfg, mesh
        self.batch, self.max_len = int(batch), int(max_len)
        self.m = mesh.shape.get("model", 1)
        self.c_specs = partition.cache_pspecs(cfg, mesh, batch)
        self.whole = transformer.cache_specs(cfg, batch, max_len)
        self.structure = tree_structure(self.whole)
        leaves = tree_leaves(self.whole)
        # each rank's block of each leaf: per dimension (index, count)
        self.blocks = []
        for r in range(mesh.size):
            coords = mesh.coords(r)
            self.blocks.append(tuple(
                tuple(_block(mesh, coords, e) for e in spec)
                for spec in tree_leaves(self.c_specs)))
        keys = {}
        self.index = [keys.setdefault((mesh.devices[r], self.blocks[r]),
                                      len(keys))
                      for r in range(mesh.size)]
        self.tree_devices = [d for d, _ in keys]
        self.tree_blocks = [b for _, b in keys]
        dp = 1
        for a in partition.batch_axes(mesh):
            dp *= mesh.shape[a]
        # batch over (pod, data) where it divides, as cache_pspecs splits
        self.n_groups = dp if self.batch % dp == 0 else 1
        self.per = self.batch // self.n_groups
        # group g's ranks: DP rank g's (rank 0's when the batch is whole)
        self.group_ranks = [[(g if self.n_groups > 1 else 0) * self.m + m
                             for m in range(self.m)]
                            for g in range(self.n_groups)]
        members = [[r for r in range(mesh.size)
                    if self.n_groups == 1 or r // self.m == g]
                   for g in range(self.n_groups)]
        # the SSM conv windows and states: the group's, on each of its ranks
        self.ssm = [tuple(dict.fromkeys(self.index[r] for r in rs))
                    for rs in members]
        self.attn = []
        # the first attention k leaf, [lead, B, S, Hkv, Dh]
        k = self.whole.get("layers", {}).get("k",
                                             self.whole.get("shared", {})
                                             .get("k"))
        if k is not None:
            i = next(j for j, x in enumerate(leaves) if x is k)
            shape = tuple(k.shape)
            self.smax = shape[2]
            self.seq_size = -(-self.smax // self.blocks[0][i][2][1])
            self.head_blocks = self.blocks[0][i][3][1]
            self.heads = shape[3] // self.head_blocks
            for rs in members:
                found: dict = {}
                for r in rs:
                    key = (self.blocks[r][i][2][0], self.blocks[r][i][3][0])
                    found.setdefault(key, []).append(self.index[r])
                self.attn.append([
                    Block(s=s, h=h, lo=s * self.seq_size, home=trees[0],
                          trees=tuple(dict.fromkeys(trees)))
                    for (s, h), trees in sorted(found.items())])

    @property
    def key(self) -> tuple:
        return (self.cfg, self.mesh, self.batch, self.max_len)

    def device(self, g: int, m: int) -> torch.device:
        return self.mesh.devices[self.group_ranks[g][m]]

    def routes_per_group(self, tokens: int) -> bool:
        """Are a group's ``tokens`` a whole number of the batch's MoE
        routing groups (``min(1024, B·S)`` tokens)?"""
        from repro_torch.models.moe import GROUP_SIZE
        return tokens % min(GROUP_SIZE, tokens * self.n_groups) == 0

    # ---- placement ------------------------------------------------------
    def init_cache(self):
        """Zeroed rank blocks (real zeros: the steps write them in place)
        → a :class:`~repro_torch.train.state.RankCache`."""
        trees = [tree_unflatten(self.structure, [
            torch.zeros([-(-n // c) for n, (_, c) in zip(leaf.shape, dims)],
                        dtype=leaf.dtype, device=dev)
            for leaf, dims in zip(tree_leaves(self.whole), blocks)])
            for dev, blocks in zip(self.tree_devices, self.tree_blocks)]
        return RankCache(trees, self)

    def gather_cache(self, cache, device) -> dict:
        """The whole cache on ``device`` from the ranks' blocks (padding
        dropped)."""
        out = []
        pieces = [tree_leaves(t) for t in cache.trees]
        for i, leaf in enumerate(tree_leaves(self.whole)):
            whole = torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
            for t, blocks in zip(pieces, self.tree_blocks):
                ix = []
                for n, (b, c) in zip(leaf.shape, blocks[i]):
                    size = -(-n // c)
                    ix.append(slice(b * size, min((b + 1) * size, n)))
                whole[tuple(ix)] = to_device(
                    t[i][tuple(slice(0, s.stop - s.start) for s in ix)],
                    whole.device)
            out.append(whole)
        return tree_unflatten(self.structure, out)

    def check_cache(self, cache) -> None:
        if cache.split.key != self.key:
            raise ValueError("the cache was placed for another config, "
                             "mesh, batch or length")

    def place_inputs(self, x: Tensor) -> tuple:
        """A step input ``[B, …]`` → each group's requests on its rank
        (k, 0), as ``batch_pspecs`` splits the batch (the steps take it
        whole or so placed)."""
        return tuple(to_device(x[g * self.per:(g + 1) * self.per],
                               self.device(g, 0))
                     for g in range(self.n_groups))

    def _piece(self, x, g: int) -> Tensor:
        if isinstance(x, (tuple, list)):
            return x[g]
        return to_device(x[g * self.per:(g + 1) * self.per],
                         self.device(g, 0))

    # ---- the steps ------------------------------------------------------
    def prefill(self, params, cache, tokens: Tensor, extra=None) -> tuple:
        """:func:`~repro_torch.models.model.prefill` split over the ranks:
        ``params`` a :class:`~repro_torch.train.state.RankShards`,
        ``cache`` this split's :class:`~repro_torch.train.state.RankCache`
        (updated in place), ``tokens`` and the ``extra`` frontend inputs
        whole or placed (:meth:`place_inputs`) → (last logits ``[B, V]``
        on the mesh's first device, cache)."""
        return self._run(params, cache, tokens, dict(extra or {}), None)

    def decode(self, params, cache, token: Tensor, pos: int) -> tuple:
        """:func:`~repro_torch.models.model.decode_step` split over the
        ranks (``pos`` a host int) → (logits ``[B, V]``, cache)."""
        return self._run(params, cache, token, {}, int(pos))

    def _run(self, params, cache, tokens, extra, pos):
        cfg = self.cfg
        self.check_cache(cache)
        groups = range(self.n_groups)
        tps = [TP([self.device(g, m) for m in range(self.m)]) for g in groups]
        ranks = [[params.on(self.device(g, m), m) for m in range(self.m)]
                 for g in groups]
        hs = [self._embed(ranks[g], tps[g], tokens, extra, g, pos)
              for g in groups]
        run = _Run(self, cache, tps, pos)
        views: dict = {}

        def layers(tree):
            # each distinct tree's layer views, once a step
            if id(tree) not in views:
                views[id(tree)] = _layers(tree)
            return views[id(tree)]

        # each layer replaces a group's h in ``hs`` as it ends, so a group
        # holds one h at a time
        if cfg.family == "ssm":
            for i in range(cfg.num_layers):
                run.mamba(hs, [layers(r[0]["layers"])[i] for r in ranks],
                          ("layers", i))
        elif cfg.family == "hybrid":
            n_sites = cfg.num_layers // cfg.attn_every
            for site in range(n_sites):
                for j in range(cfg.attn_every):
                    run.mamba(hs, [_layers(layers(r[0]["layers"])[site])[j]
                                   for r in ranks], ("layers", (site, j)))
                run.block([[r["shared_attn"] for r in rk] for rk in ranks],
                          hs, ("shared", site))
            for i in range(cfg.num_layers - n_sites * cfg.attn_every):
                run.mamba(hs, [layers(r[0]["trailing"])[i] for r in ranks],
                          ("trailing", i))
        else:
            for i in range(cfg.num_layers):
                run.block([[layers(r["layers"])[i] for r in rk]
                           for rk in ranks], hs, ("layers", i))
        run.sync_ssm()
        out = [_logits(cfg, ranks[g], rms_norm(
            hs[g][:, -1:], ranks[g][0]["final_norm"], cfg.norm_eps),
            tps[g])[:, 0] for g in groups]
        del hs
        return self.join(out), cache

    def _embed(self, ranks: list, tp, tokens, extra: dict, g: int, pos):
        """Group g's embedded inputs on its rank (k, 0)."""
        mine = {k: self._piece(v, g) for k, v in extra.items()}
        h = model_mod.embed_inputs_tp(
            self.cfg, ranks, self._piece(tokens, g), tp,
            mine.get("frontend_embeds"), mine.get("frontend_mask"))
        return h[:, None, :] if pos is not None else h

    def join(self, pieces: list) -> Tensor:
        """The groups' last logits, each on its rank (k, 0) → ``[B, V]`` on
        the mesh's first device."""
        home = self.mesh.devices[0]
        if len(pieces) == 1:
            return to_device(pieces[0], home)
        return torch.cat([to_device(p, home) for p in pieces])


def _logits(cfg: ModelConfig, ranks: list, h: Tensor, tp) -> Tensor:
    """Vocab-parallel logits gathered on rank 0's device (whole there
    where the vocabulary does not divide)."""
    if tp.m == 1 or not tp.split(cfg.padded_vocab)[0]:
        return model_mod.lm_logits(cfg, ranks[0], h)
    parts = []
    for m, (r, dev) in enumerate(zip(ranks, tp.devices)):
        lo, width = model_mod._vocab_range(tp, cfg, m)
        parts.append(to_device(model_mod._logits_shard(
            cfg, r, to_device(h, dev), lo, width), tp.home))
    return torch.cat(parts, -1)


class _Run:
    """One prefill or decode over a split's groups (``pos`` None for a
    prefill)."""

    def __init__(self, split: ServeSplit, cache, tps: list, pos):
        self.sp, self.cache, self.tps, self.pos = split, cache, tps, pos
        self.cfg = split.cfg
        self.views: dict = {}

    def view(self, t: int, site: tuple, leaf: str) -> Tensor:
        """Tree t's view of a cache leaf at one layer (``site`` = (name,
        layer) or (name, (site, layer)) for the hybrid stack)."""
        name, idx = site
        key = (t, name, leaf)
        if key not in self.views:
            self.views[key] = list(self.cache.trees[t][name][leaf].unbind(0))
        if isinstance(idx, tuple):
            return self.views[key][idx[0]][idx[1]]
        return self.views[key][idx]

    # ---- mamba ------------------------------------------------------------
    def mamba(self, hs: list, ps: list, site: tuple) -> None:
        """One mamba layer per group on rank (k, 0) with the group's conv
        window and state (updated in place there); ``hs[g]`` replaced."""
        for g, p in enumerate(ps):
            home = self.sp.ssm[g][0]
            c = {k: self.view(home, site, k) for k in ("conv", "state")}
            hs[g] = transformer._mamba_layer(self.cfg, p, hs[g], c)[0]

    def sync_ssm(self) -> None:
        """Each group's new conv windows and states, stacked, copied from
        rank (k, 0) to the ranks that replicate them (once a step: only
        rank (k, 0)'s are read)."""
        for trees in self.sp.ssm:
            src = self.cache.trees[trees[0]]
            for t in trees[1:]:
                for name, leaves in self.cache.trees[t].items():
                    for leaf in ("conv", "state"):
                        if leaf in leaves:
                            leaves[leaf].copy_(src[name][leaf])

    # ---- a transformer block --------------------------------------------
    def block(self, ps: list, hs: list, site: tuple) -> None:
        """The training form's pre-LN block (attention + MLP, or MoE) of
        every group with its cache site: ``ps[g][m]`` group g's rank-m
        layer tree, ``hs[g]`` replaced. An MoE whose groups' tokens are
        not whole routing groups routes once over the gathered batch."""
        cfg = self.cfg
        t = hs[0].shape[0] * hs[0].shape[1]
        gathered = cfg.family == "moe" and site[0] == "layers" and \
            not self.sp.routes_per_group(t)
        for g, (p, tp) in enumerate(zip(ps, self.tps)):
            c = _Site(self, g, site)
            if site[0] == "shared":
                hs[g] = transformer._shared_block_tp(cfg, p, hs[g], tp, c)
            elif gathered:
                hs[g] = transformer._attn_residual_tp(cfg, p, hs[g], tp, c)
            else:
                hs[g] = transformer._dense_layer_tp(cfg, p, hs[g], tp, c)[0]
        if gathered:
            ys = self.moe_gathered([[q["mlp"] for q in p] for p in ps], [
                rms_norm(h, p[0]["ln2"], cfg.norm_eps)
                for h, p in zip(hs, ps)])
            for g, y in enumerate(ys):
                hs[g] = hs[g] + y

    def moe_gathered(self, mlps: list, xs: list) -> list:
        """The MoE FFN routed once over the batch gathered on group 0's
        rank 0, its experts on group 0's ranks, the outputs sent back."""
        b = xs[0].shape[0]
        home = self.tps[0].home
        y, _ = transformer._moe_apply_tp(
            self.cfg, mlps[0], torch.cat([to_device(x, home) for x in xs]),
            self.tps[0])
        return [to_device(y[g * b:(g + 1) * b], x.device)
                for g, x in enumerate(xs)]


class _Site:
    """Group g's cache blocks at one attention site, as
    :func:`~repro_torch.models.attention.run_attention_tp` takes them:
    ``pos`` (None for a prefill), :meth:`write` and :meth:`attend`."""

    def __init__(self, run: _Run, g: int, site: tuple):
        self.run, self.g, self.site = run, g, site
        self.pos = run.pos

    def write(self, kvs: list, s: int) -> None:
        """The new k/v into group g's blocks: a prefill's rows into every
        block's slots, a decode's one row into the block that owns slot
        ``pos % smax``; ``kvs`` holds one (k, v) per kv head block, or one
        of all heads."""
        sp, pos = self.run.sp, self.pos
        smax, size = sp.smax, sp.seq_size
        if pos is None:
            if s > smax:
                # SWA ring shorter than the prompt: the last smax positions
                # land on slots 0..smax-1 (s % smax == 0, as configs comply)
                assert s % smax == 0, (s, smax)
                kvs = [(k[:, s - smax:], v[:, s - smax:]) for k, v in kvs]
            rows = min(s, smax)
        else:
            slot = pos % smax
        for blk in sp.attn[self.g]:
            if pos is None:
                lo, n = blk.lo, min(size, rows - blk.lo)
                at = slice(0, n)
            else:
                if slot // size != blk.s:
                    continue
                lo, n = slot, s
                at = slice(slot - blk.lo, slot - blk.lo + s)
            if n <= 0:
                continue
            k, v = kvs[blk.h] if len(kvs) > 1 else kvs[0]
            if pos is None:
                k, v = k[:, lo:lo + n], v[:, lo:lo + n]
            if len(kvs) == 1 and sp.head_blocks > 1:
                hs = slice(blk.h * sp.heads, (blk.h + 1) * sp.heads)
                k, v = k[:, :, hs], v[:, :, hs]
            for t in blk.trees:
                for name, src in (("k", k), ("v", v)):
                    self.run.view(t, self.site, name)[:, at].copy_(src)

    def attend(self, qs: list) -> list:
        """Decode attention over group g's cache blocks → one output a q
        head block (``qs[j]`` on rank j's device). Where the blocks hold
        the kv heads of one rank, q block j meets the blocks of its heads;
        where they hold every kv head, the q heads are gathered on rank
        (k, 0), every block gives one piece for all of them, and the
        output's head blocks go back to their ranks."""
        run, sp = self.run, self.run.sp
        tp = run.tps[self.g]
        window, smax = run.cfg.sliding_window, sp.smax
        kw = dict(window=window if (window == 0 or smax > window) else 0,
                  ring=smax <= max(window, 0) and window > 0)

        def piece(blk, q):
            k = run.view(blk.home, self.site, "k")
            v = run.view(blk.home, self.site, "v")
            return decode_partial(to_device(q, k.device), k, v, blk.lo,
                                  self.pos, smax, **kw)

        blocks = sp.attn[self.g]
        if sp.head_blocks > 1:
            return [combine_partials([piece(blk, q) for blk in blocks
                                      if blk.h == j], q.device, q.dtype)
                    for j, q in enumerate(qs)]
        q = (qs[0] if len(qs) == 1 else
             torch.cat([to_device(x, tp.home) for x in qs], dim=2))
        o = combine_partials([piece(blk, q) for blk in blocks], tp.home,
                             q.dtype)
        if len(qs) == 1:
            return [o]
        hq = qs[0].shape[2]
        return [to_device(o[:, :, j * hq:(j + 1) * hq], x.device)
                for j, x in enumerate(qs)]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def place_params(params, cfg: ModelConfig, mesh):
    """A whole params tree → its :class:`~repro_torch.train.state.
    RankShards` on ``mesh`` by ``param_pspecs`` (each (device, column) of
    the ranks its column's tree)."""
    return shard_params(params, partition.param_pspecs(cfg, mesh), mesh)


def init_cache(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """The decode cache of ``batch`` requests and ``max_len`` positions
    placed on ``mesh`` by ``cache_pspecs`` (zeros)."""
    return ServeSplit(cfg, mesh, batch, max_len).init_cache()


def split_of(cfg: ModelConfig, mesh, cache) -> ServeSplit:
    """The :class:`ServeSplit` that placed ``cache``, which must be
    ``cfg``'s on ``mesh``."""
    split = cache.split
    if (split.cfg, split.mesh) != (cfg, mesh):
        raise ValueError("the cache was placed for another config or mesh")
    return split


def is_split(mesh) -> bool:
    """Does ``mesh`` split a serving step (several ranks)?"""
    return mesh is not None and mesh.size > 1

