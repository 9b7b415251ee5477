"""Shared helpers of the LM parity tests (``tests/test_torch_lm_*.py``).

The reference runs under ``jax.jit`` (one compile per configuration: the
forward, the loss, prefill and one decode step in one function); its
params, drawn by ``repro``'s ``init_params``, are carried to the port as
numpy arrays by ``repro_torch.convert.lm_params``, so both packages compute
on the same weights and tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models.stubs import audio_stub_embeds as ref_audio
from repro.models.stubs import vision_stub_embeds as ref_vision
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as lm

# f32 parity: logits of magnitude ~1 agree to ~2e-6 (summation order of the
# einsums), so elementwise rtol = atol = 2e-5. bf16 parity: the two
# packages round bf16 intermediates in different places (XLA keeps fused
# elementwise chains in f32; torch's silu/softplus/exp round once per op),
# so bf16 ulps (2**-8 of a value) flip here and there and spread through
# the layers. The bf16 cases are held per leaf in norm: ‖Δ‖₂ ≤
# 2**-4·‖ref‖₂ and max |Δ| ≤ 2**-3·max |ref| over the real vocabulary;
# measured worst, zamba2's trailing SSD state: 0.031 and 0.025; every
# other architecture ≤ 0.013 and 0.014
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rel_l2=2 ** -4, max_frac=2 ** -3)
B, S, MAX_LEN = 2, 12, 16


def configs(arch: str, **kw):
    """(reference config, port config): SMOKE with ``kw`` replaced."""
    return (dataclasses.replace(ref_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def flat(tree, prefix="") -> dict:
    """``{"a/b/c": leaf}`` of a nested dict (either package's tree)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def np_of(x) -> np.ndarray:
    """A reference or port leaf as float32 (or its int) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or \
        x.dtype.name == "bfloat16" else x


def assert_close(got, want, tol, what=""):
    got, want = np_of(got), np_of(want)
    if "rel_l2" not in tol:
        np.testing.assert_allclose(got, want, err_msg=what, **tol)
        return
    assert got.shape == want.shape, what
    real = want > -1e29                   # padded vocab slots are -1e30
    d = (got - want)[real].astype(np.float64)
    w = want[real].astype(np.float64)
    assert np.linalg.norm(d) <= tol["rel_l2"] * np.linalg.norm(w), (
        what, np.linalg.norm(d) / np.linalg.norm(w))
    assert np.abs(d).max(initial=0) <= tol["max_frac"] * np.abs(w).max(
        initial=0), (what, np.abs(d).max(), np.abs(w).max())
    np.testing.assert_array_equal(got[~real], want[~real])


def assert_trees_close(got, want, tol, what=""):
    """Same keys, shapes and dtypes; leaves within ``tol``."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w), (what, sorted(g), sorted(w))
    for k in w:
        assert tuple(g[k].shape) == tuple(np.shape(w[k])), (what, k)
        assert str(g[k].dtype).split(".")[-1] == np.asarray(w[k]).dtype.name
        assert_close(g[k], w[k], tol, f"{what} {k}")


def inputs(cfg, seed=0, b=B, s=S) -> dict:
    """Tokens, labels and the frontend stub embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.frontend == "vision":
        fe, m = ref_vision(cfg, jax.random.PRNGKey(3), b, s, 4)
        out |= {"frontend_embeds": np.asarray(fe),
                "frontend_mask": np.asarray(m)}
    elif cfg.frontend == "audio":
        out["frontend_embeds"] = np.asarray(
            ref_audio(cfg, jax.random.PRNGKey(3), b, s))
    return out


def ref_params(cfg, seed=0) -> dict:
    p = jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def ref_run(cfg, params, batch) -> dict:
    """The reference's forward (with the frontend stubs, if any), loss,
    prefill of all tokens but the last and decode of the last."""
    fe = batch.get("frontend_embeds")
    fm = batch.get("frontend_mask")

    def run(p, toks, labels, fe, fm):
        logits, aux = ref_model.forward(cfg, p, toks, fe, fm)
        b = {"tokens": toks, "labels": labels}
        if fe is not None:
            b["frontend_embeds"] = fe
        if fm is not None:
            b["frontend_mask"] = fm
        loss, parts = ref_model.loss_fn(cfg, p, b)
        plain, _ = ref_model.forward(cfg, p, toks)
        cache = ref_model.init_cache(cfg, toks.shape[0], MAX_LEN)
        last, cache_p = ref_model.prefill(cfg, p, toks[:, :-1], cache)
        step, cache_d = ref_model.decode_step(
            cfg, p, cache_p, toks[:, -1], jnp.int32(toks.shape[1] - 1))
        return dict(logits=logits, aux=aux, loss=loss, ce=parts["ce"],
                    plain=plain, last=last, cache_prefill=cache_p,
                    step=step, cache_decode=cache_d)

    out = jax.jit(run)(params, batch["tokens"], batch["labels"], fe, fm)
    return jax.tree.map(np.asarray, out)


def port_run(cfg, params, batch) -> dict:
    """The port's counterpart of :func:`ref_run` on the CPU (the prefill
    cache is copied before decode consumes it)."""
    t = convert.lm_params(batch, "cpu")
    toks = t["tokens"].long()
    fe, fm = t.get("frontend_embeds"), t.get("frontend_mask")
    with torch.inference_mode():
        logits, aux = lm.forward(cfg, params, toks, fe, fm)
        b = {"tokens": toks, "labels": t["labels"].long()}
        if fe is not None:
            b["frontend_embeds"] = fe
        if fm is not None:
            b["frontend_mask"] = fm
        loss, parts = lm.loss_fn(cfg, params, b)
        plain, _ = lm.forward(cfg, params, toks)
        cache = lm.init_cache(cfg, toks.shape[0], MAX_LEN, "cpu")
        last, cache = lm.prefill(cfg, params, toks[:, :-1], cache)
        cache_p = {k: v.clone() for k, v in flat(cache).items()}
        step, cache_d = lm.decode_step(cfg, params, cache, toks[:, -1],
                                       toks.shape[1] - 1)
    return dict(logits=logits, aux=aux, loss=loss, ce=parts["ce"],
                plain=plain, last=last, cache_prefill=cache_p, step=step,
                cache_decode=cache_d)


def check_run(got, want, tol, what):
    for key in ("logits", "aux", "loss", "ce", "plain", "last", "step"):
        assert_close(got[key], want[key], tol, f"{what} {key}")
    assert_trees_close(got["cache_decode"], want["cache_decode"], tol,
                       f"{what} decode cache")
    want_p = flat(want["cache_prefill"])
    assert sorted(got["cache_prefill"]) == sorted(want_p)
    for k, v in want_p.items():
        assert_close(got["cache_prefill"][k], v, tol,
                     f"{what} prefill cache {k}")


def parity(arch: str, tol=F32, **kw):
    """Reference and port on one SMOKE config (``kw`` replaced): the
    reference's and the port's results, compared leaf for leaf."""
    ref_cfg, cfg = configs(arch, **kw)
    params = ref_params(ref_cfg)
    batch = inputs(ref_cfg)
    want = ref_run(ref_cfg, params, batch)
    got = port_run(cfg, convert.lm_params(params, "cpu"), batch)
    check_run(got, want, tol, f"{arch} {kw}")
    return got, want
