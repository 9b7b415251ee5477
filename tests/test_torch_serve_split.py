"""Serving split over a mesh (``repro_torch.models.serve_split``, the
split ``build_prefill_step``/``build_serve_step``) against the whole form
and the reference.

SMOKE configs in f32 on ``["cpu"] * n`` meshes, one per cache layout of
``cache_pspecs``:

* (2, 2), batch 2 — requests over ``data``, heads and kv heads over
  ``model``;
* (1, 3), batch 1 — 3 divides no config's kv heads here, so the cache's
  sequence (mixtral: its SWA ring) goes over ``model``, in blocks padded
  as XLA pads (32 ring slots → 3 × 11);
* (4, 1) and (2, 2), batch 1 — the batch does not divide the DP ranks:
  split-K decode over ``data`` (with heads over ``model`` on (2, 2));
* ``["cpu", "cpu:0"] * 2`` on (2, 2) — two mesh devices, so the ranks'
  blocks and sums cross devices;
* (1, 4), batch 2 — phi4's 6 q heads and 2 kv heads do not divide 4, so a
  prompt whose length 4 divides splits its queries by sequence block over
  ``model`` (``attention.query_blocks``) and one whose length it does not
  runs the attention whole on rank 0.

For dense GQA (phi4), MoE with an SWA ring (mixtral, whose prompt fills
the 32-slot ring and whose decode runs 17 steps past it), SSM (mamba2)
and hybrid (zamba2): the split prefill's logits and each split decode
step's equal the whole form's (rtol = atol = 1e-5), teacher-forced, and
the gathered cache equals the whole cache. For one case per layout the
split form equals the reference's jitted ``prefill``/``decode_step`` on
the same numpy weights (``_torch_lm.F32``). Each rank's tree holds exactly
``rank_bytes`` of the params and of the cache under ``param_pspecs`` and
``cache_pspecs``; the split serve steps and ``generate`` over a mesh give
the whole form's tokens; vlm and audio split their frontend inputs by
request, and granite's one kv head puts the cache's sequence over
``model``; and a split-K decode that drops the ``exp(max_r − max)``
rescale of its pieces fails the comparison.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import F32, assert_close, configs, ref_params
from repro.models import model as ref_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, partition, serve_split
from repro_torch.models import model as lm
from repro_torch.models.transformer import tree_leaves
from repro_torch.train.step import build_prefill_step, build_serve_step

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
FAMILIES = ("phi4-mini-3.8b", "mixtral-8x7b", "mamba2-130m", "zamba2-1.2b")
# name → (mesh shape, devices, batch)
LAYOUTS = {
    "heads over model": ((2, 2), ["cpu"] * 4, 2),
    "seq over model": ((1, 3), ["cpu"] * 3, 1),
    "split-K over data": ((4, 1), ["cpu"] * 4, 1),
    "split-K over data, heads over model": ((2, 2), ["cpu"] * 4, 1),
    "two devices": ((2, 2), ["cpu", "cpu:0"] * 2, 2),
}


def _prompt(arch) -> int:
    # mixtral's prompt fills its 32-slot SWA ring, so decode runs past it
    return 32 if arch == "mixtral-8x7b" else 12


def _gen(arch) -> int:
    return 18 if arch == "mixtral-8x7b" else 6


def _tokens(cfg, batch: int, total: int) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, (batch, total),
                         generator=torch.Generator().manual_seed(7))


def _whole(cfg, params, toks, s, gen):
    """The whole form, teacher-forced: the prefill's logits, each decode
    step's, and the final cache."""
    with torch.inference_mode():
        cache = lm.init_cache(cfg, toks.shape[0], s + gen, "cpu")
        out, cache = lm.prefill(cfg, params, toks[:, :s], cache)
        outs = [out]
        for i in range(gen - 1):
            out, cache = lm.decode_step(cfg, params, cache, toks[:, s + i],
                                        s + i)
            outs.append(out)
    return outs, cache


def _split(cfg, params, toks, s, gen, mesh):
    """The split form on ``mesh``, fed the same tokens."""
    sp = serve_split.ServeSplit(cfg, mesh, toks.shape[0], s + gen)
    placed = serve_split.place_params(params, cfg, mesh)
    with torch.inference_mode():
        cache = sp.init_cache()
        out, cache = sp.prefill(placed, cache, toks[:, :s])
        outs = [out]
        for i in range(gen - 1):
            out, cache = sp.decode(placed, cache, toks[:, s + i], s + i)
            outs.append(out)
    return outs, cache, sp, placed


def _mesh(layout):
    shape, devices, batch = LAYOUTS[layout]
    return make_mesh(shape, ("data", "model"), devices), batch


def _leaves(tree):
    return tree_leaves(tree)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_split_serving_equals_the_whole_form(arch, layout):
    cfg = get_config(arch, smoke=True)
    mesh, batch = _mesh(layout)
    s, gen = _prompt(arch), _gen(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = _tokens(cfg, batch, s + gen)
    want, cache = _whole(cfg, params, toks, s, gen)
    got, placed_cache, sp, _ = _split(cfg, params, toks, s, gen, mesh)
    for step, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, **TOL,
                                   msg=f"{arch} {layout} step {step}")
    whole = sp.gather_cache(placed_cache, "cpu")
    for a, b in zip(_leaves(whole), _leaves(cache)):
        torch.testing.assert_close(a, b, **TOL)
    # the layout the specs give
    if cfg.family != "ssm":
        c = sp.attn[0]
        n_seq = len({blk.s for blk in c})
        if layout.startswith("split-K"):
            assert sp.n_groups == 1 and n_seq == mesh.shape["data"]
        elif layout == "seq over model":
            assert n_seq == 3 and sp.head_blocks == 1
        else:
            assert sp.n_groups == 2 and n_seq == 1
            assert sp.head_blocks == (2 if cfg.num_kv_heads % 2 == 0
                                      else 1)


@pytest.mark.parametrize("layout", ["heads over model", "seq over model",
                                    "split-K over data"])
def test_each_rank_holds_its_rank_bytes(layout):
    """On a mesh of one fake device a rank (``dryrun.rank_mesh``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh, batch = _mesh(layout)
    mesh = dryrun.rank_mesh(mesh)
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True)
        max_len = _prompt(arch) + _gen(arch)
        c_want = dryrun.rank_bytes(
            lm.cache_specs(cfg, batch, max_len),
            partition.cache_pspecs(cfg, mesh, batch), mesh)
        p_want = dryrun.rank_bytes(lm.param_specs(cfg),
                                   partition.param_pspecs(cfg, mesh), mesh)
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = dryrun._materialize(lm.param_specs(cfg),
                                         mesh.devices[0])
            placed = serve_split.place_params(params, cfg, mesh)
            cache = serve_split.init_cache(cfg, mesh, batch, max_len)
            for r, dev in enumerate(mesh.devices):
                tree = cache.rank(r)
                assert {str(x.device) for x in _leaves(tree)} == {str(dev)}
                assert sum(x.nbytes for x in _leaves(tree)) == c_want, (
                    arch, layout, r)
                p = placed.on(dev, r % mesh.shape["model"])
                assert sum(x.nbytes for x in _leaves(p)) == p_want


def _ref_run(arch, toks, s, gen):
    """The reference's jitted prefill and decode steps, teacher-forced on
    ``toks``, and the port's params from the same numpy weights."""
    ref_cfg, cfg = configs(arch)
    params = ref_params(ref_cfg)
    prefill = jax.jit(lambda p, t, c: ref_model.prefill(ref_cfg, p, t, c))
    decode = jax.jit(
        lambda p, c, t, pos: ref_model.decode_step(ref_cfg, p, c, t, pos))
    t = jnp.asarray(toks.numpy().astype(np.int32))
    cache = ref_model.init_cache(ref_cfg, toks.shape[0], s + gen)
    out, cache = prefill(params, t[:, :s], cache)
    outs = [np.asarray(out)]
    for i in range(gen - 1):
        out, cache = decode(params, cache, t[:, s + i], jnp.int32(s + i))
        outs.append(np.asarray(out))
    return cfg, convert.lm_params(params, "cpu"), outs


@pytest.mark.parametrize("arch,layout", [
    ("phi4-mini-3.8b", "heads over model"),
    ("mixtral-8x7b", "seq over model"),
    ("zamba2-1.2b", "split-K over data, heads over model"),
    ("mamba2-130m", "split-K over data")])
def test_split_serving_equals_the_reference(arch, layout):
    mesh, batch = _mesh(layout)
    s, gen = _prompt(arch), _gen(arch)
    cfg = get_config(arch, smoke=True)
    toks = _tokens(cfg, batch, s + gen)
    cfg, params, want = _ref_run(arch, toks, s, gen)
    got, *_ = _split(cfg, params, toks, s, gen, mesh)
    for step, (a, b) in enumerate(zip(got, want)):
        assert_close(a, b, F32, f"{arch} {layout} step {step}")


def test_the_split_serve_steps_give_the_whole_forms_tokens():
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    mesh, batch = _mesh("seq over model")
    s, gen = 12, 5
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = _tokens(cfg, batch, s)
    one = make_mesh((1, 1), ("data", "model"), ["cpu"])
    runs = []
    for m, p, c in (
            (one, params, lm.init_cache(cfg, batch, s + gen, "cpu")),
            (mesh, serve_split.place_params(params, cfg, mesh),
             serve_split.init_cache(cfg, mesh, batch, s + gen))):
        tok, c = build_prefill_step(cfg, m)(p, c, prompts)
        out = [tok]
        for i in range(gen - 1):
            tok, c = build_serve_step(cfg, m)(p, c, tok, s + i)
            out.append(tok)
        runs.append(torch.stack(out, 1))
    assert runs[0].dtype == runs[1].dtype == torch.int32
    assert torch.equal(runs[0], runs[1])
    # a mesh of several ranks takes placed params and cache
    with pytest.raises(ValueError, match="placed"):
        build_prefill_step(cfg, mesh)(
            params, lm.init_cache(cfg, batch, s + gen, "cpu"), prompts)


@pytest.mark.parametrize("layout", ["seq over model", "split-K over data"])
def test_dropping_the_rescale_of_the_pieces_fails(monkeypatch, layout):
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    mesh, batch = _mesh(layout)
    s, gen = 12, 6
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = _tokens(cfg, batch, s + gen)
    want, _ = _whole(cfg, params, toks, s, gen)
    monkeypatch.setattr(attention, "_rescale",
                        lambda top, total: torch.ones_like(top))
    got, *_ = _split(cfg, params, toks, s, gen, mesh)
    torch.testing.assert_close(got[0], want[0], **TOL)     # prefill
    err = max(float((a - b).abs().max()) for a, b in zip(got[1:], want[1:]))
    assert err > 100 * TOL["atol"], err
    assert math.isfinite(err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [12, 13])
def test_a_split_prefill_splits_its_queries_where_heads_do_not_divide(
        monkeypatch, s, dtype):
    """phi4 SMOKE on (1, 4): 4 divides neither its 6 q heads nor its 2 kv
    heads. A 12-token prompt's attention runs on the 4 ranks' query blocks
    (offsets 0, 3, 6, 9), a 13-token one whole on rank 0; both equal the
    whole form, teacher-forced (f32 to ``TOL``; bf16 to a relative L2 of
    5e-2 per step)."""
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b", smoke=True),
                              param_dtype=dtype)
    mesh = make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)
    gen = 5
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = _tokens(cfg, 2, s + gen)
    want, cache = _whole(cfg, params, toks, s, gen)
    calls = []
    real = attention.plain_attention

    def spy(q, k, v, **kw):
        calls.append((kw.get("q_offset", 0), q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "plain_attention", spy)
    got, placed_cache, sp, _ = _split(cfg, params, toks, s, gen, mesh)
    prefill = [c for c in calls if c[2] == s]
    blocks = ([(m * s // 4, s // 4, s) for m in range(4)] if s % 4 == 0
              else [(0, s, s)])
    assert prefill == blocks * cfg.num_layers, prefill
    for step, (a, b) in enumerate(zip(got, want)):
        if dtype == "float32":
            torch.testing.assert_close(a, b, **TOL,
                                       msg=f"s={s} step {step}")
        else:
            err = float((a.float() - b.float()).norm() / b.float().norm())
            assert err <= 5e-2, (s, step, err)
    if dtype == "float32":
        for a, b in zip(_leaves(sp.gather_cache(placed_cache, "cpu")),
                        _leaves(cache)):
            torch.testing.assert_close(a, b, **TOL)


def test_generate_over_a_mesh_gives_the_whole_forms_tokens():
    """``launch.serve.generate`` with a mesh of several ranks (the CLI's
    ``(n, 1)`` mesh of n cards, here of two CPU devices) places the whole
    params itself and gives the one-device loop's tokens and logits."""
    from repro_torch.launch.serve import generate
    cfg = get_config("mixtral-8x7b", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = _tokens(cfg, 2, 16)
    want = generate(cfg, params, prompts, 8, "cpu", keep_logits=True)
    mesh = make_mesh((2, 1), ("data", "model"), ["cpu", "cpu:0"])
    got = generate(cfg, params, prompts, 8, "cpu", keep_logits=True,
                   mesh=mesh)
    assert torch.equal(got.tokens, want.tokens)
    for a, b in zip(got.logits, want.logits):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("arch", ["internvl2-26b", "musicgen-medium",
                                  "granite-34b"])
def test_the_other_archs_split_as_the_whole_form(arch):
    """The frontends' inputs split by request (vision: patch embeddings
    and their mask; audio: conditioning frames), and granite's one kv
    head, replicated over ``model``, with the cache's sequence there."""
    from repro_torch.models.stubs import audio_stub_embeds, vision_stub_embeds
    cfg = get_config(arch, smoke=True)
    mesh, batch = _mesh("heads over model")
    s, gen = 12, 4
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = _tokens(cfg, batch, s + gen)
    gen_ = torch.Generator().manual_seed(2)
    extra = {}
    if cfg.frontend == "vision":
        fe, fm = vision_stub_embeds(cfg, gen_, batch, s, 4, "cpu")
        extra = dict(frontend_embeds=fe, frontend_mask=fm)
    elif cfg.frontend == "audio":
        extra = dict(frontend_embeds=audio_stub_embeds(cfg, gen_, batch, s,
                                                       "cpu"))
    sp = serve_split.ServeSplit(cfg, mesh, batch, s + gen)
    placed = serve_split.place_params(params, cfg, mesh)
    with torch.inference_mode():
        cache = lm.init_cache(cfg, batch, s + gen, "cpu")
        want, cache = lm.prefill(cfg, params, toks[:, :s], cache, **extra)
        split = sp.init_cache()
        got, split = sp.prefill(placed, split, toks[:, :s], extra)
        torch.testing.assert_close(got, want, **TOL)
        # the inputs placed by request on each group's rank (k, 0)
        again, _ = sp.prefill(placed, sp.init_cache(),
                              sp.place_inputs(toks[:, :s]),
                              {k: sp.place_inputs(v)
                               for k, v in extra.items()})
        assert torch.equal(again, got)
        for i in range(gen - 1):
            want, cache = lm.decode_step(cfg, params, cache, toks[:, s + i],
                                         s + i)
            got, split = sp.decode(placed, split, toks[:, s + i], s + i)
            torch.testing.assert_close(got, want, **TOL)
    if arch == "granite-34b":
        assert sp.head_blocks == 1 and len(sp.attn[0]) == 2
