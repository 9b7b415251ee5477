"""The port's LM building blocks against the JAX reference, function by
function, on the same numpy inputs.

``models/layers.py``, ``attention.py``, ``moe.py``, ``ssm.py`` and
``stubs.py`` (the reference's composite functions under ``jax.jit``):
float32 results agree to summation order (rtol = atol = 2e-5,
``_torch_lm.F32``), the integer-valued ones (one-hot dispatch, kept
slots, capacities) exactly; bf16 inputs of the f32-computing norms and
RoPE to one bf16 ulp of the result (rtol = atol = 2**-7). Covered beyond
the model tests: ``blocked_attention`` at ``q_chunk=4`` against both the
reference's blocked and plain forms, with and without a window;
``decode_attention`` plain, windowed and on a ring; ``run_attention``'s
prefill into a ring shorter than the prompt; ``moe_ffn`` dropping tokens
under a small capacity factor at top-1 and top-2, on router ties and over
several groups; ``ssd_chunked`` against ``naive_ssd``; ``mamba2_block``
unpadded, padded, seeding a cache and decoding one token.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import F32, assert_close
from repro.configs import get_config as ref_get_config
from repro.models import attention as ra
from repro.models import layers as rl
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro.models.stubs import vision_stub_embeds as ref_vision_stub
from repro_torch.configs import get_config
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import stubs

torch.set_num_threads(1)

BF16_ULP = dict(rtol=2 ** -7, atol=2 ** -7)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def _j(x, dtype=None):
    a = jnp.asarray(x)
    return a if dtype is None else a.astype(dtype)


def _jit(fn, *args, **kw):
    """The reference ``fn(*args, **kw)`` under ``jax.jit`` (keywords
    static): one compile instead of one per eager op."""
    return jax.jit(functools.partial(fn, **kw))(*args)


# ---------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_compute_in_f32_and_cast_back(dtype):
    rng = _rng()
    x, scale = _f(rng, 2, 5, 3, 16), _f(rng, 16)
    tdt = getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16_ULP
    got = tl.rms_norm(_t(x, tdt), _t(scale, tdt), 1e-5)
    want = rl.rms_norm(_j(x, dtype), _j(scale, dtype), 1e-5)
    assert got.dtype == tdt
    assert_close(got, want, tol, "rms_norm")
    for pos in (np.arange(5)[None, :], np.array([[7] * 5, [3] * 5])):
        got = tl.apply_rope(_t(x, tdt), _t(pos), 1e4)
        want = rl.apply_rope(_j(x, dtype), _j(pos), 1e4)
        assert got.dtype == tdt
        assert_close(got, want, tol, "apply_rope")
    assert_close(tl.rope_freqs(16, 5e5), rl.rope_freqs(16, 5e5), F32)


def test_swiglu_and_causal_conv1d():
    rng = _rng(1)
    x, wg, wu, wd = (_f(rng, 2, 5, 8), _f(rng, 8, 12), _f(rng, 8, 12),
                     _f(rng, 12, 8))
    assert_close(tl.swiglu(*map(_t, (x, wg, wu, wd))),
                 rl.swiglu(*map(_j, (x, wg, wu, wd))), F32, "swiglu")
    w, cache = _f(rng, 4, 8), _f(rng, 2, 3, 8)
    for c in (None, cache):
        got = tl.causal_conv1d(_t(x), _t(w), None if c is None else _t(c))
        want = rl.causal_conv1d(_j(x), _j(w), None if c is None else _j(c))
        for g, wv in zip(got, want):
            assert_close(g, wv, F32, "causal_conv1d")


def test_initializers_draw_the_reference_shapes_dtypes_and_scales():
    gen = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    w = tl.dense_init(gen, 256, 768, torch.bfloat16, cpu, (3,))
    assert w.shape == (3, 256, 768) and w.dtype == torch.bfloat16
    assert float(w.float().std()) == pytest.approx((2 / 1024) ** 0.5,
                                                   rel=0.02)
    e = tl.embed_init(gen, 512, 64, torch.float32, cpu)
    assert e.shape == (512, 64) and float(e.std()) == pytest.approx(
        0.02, rel=0.02)
    meta = tl.dense_init(None, 4, 8, torch.bfloat16, torch.device("meta"))
    assert meta.is_meta and meta.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# attention.py
# ---------------------------------------------------------------------------

def _qkv(rng, b=2, sq=16, sk=16, hq=6, hkv=2, dh=8):
    return _f(rng, b, sq, hq, dh), _f(rng, b, sk, hkv, dh), _f(rng, b, sk,
                                                                hkv, dh)


@pytest.mark.parametrize("window", [0, 5])
def test_plain_attention_with_offsets(window):
    q, k, v = _qkv(_rng(2), sq=4, sk=16)
    for q_off, k_off in ((0, 0), (12, 0), (20, 9)):
        got = ta.plain_attention(_t(q), _t(k), _t(v), window=window,
                                 q_offset=q_off, k_offset=k_off)
        want = ra.plain_attention(_j(q), _j(k), _j(v), window=window,
                                  q_offset=q_off, k_offset=k_off)
        assert_close(got, want, F32, f"plain {q_off} {k_off}")


@pytest.mark.parametrize("window", [0, 6])
def test_blocked_attention_equals_the_references_blocked_and_plain(window):
    """The reference's docstring says blocked ≡ plain; this holds the
    port's blocked form to both of the reference's forms at q_chunk=4."""
    q, k, v = _qkv(_rng(3))
    got = ta.blocked_attention(_t(q), _t(k), _t(v), window=window,
                               q_chunk=4, k_chunk=4)
    want_blocked = ra.blocked_attention(_j(q), _j(k), _j(v), window=window,
                                        q_chunk=4, k_chunk=4)
    want_plain = ra.plain_attention(_j(q), _j(k), _j(v), window=window)
    assert_close(got, want_blocked, F32, "blocked = reference blocked")
    assert_close(got, want_plain, F32, "blocked = reference plain")
    assert_close(got, ta.plain_attention(_t(q), _t(k), _t(v),
                                         window=window), F32)


@pytest.mark.parametrize("window,ring", [(0, False), (5, False), (8, True)])
def test_decode_attention_plain_windowed_and_ring(window, ring):
    q, k, v = _qkv(_rng(4), sq=1, sk=8)
    for pos in (2, 7, 11):
        got = ta.decode_attention(_t(q), _t(k), _t(v), pos, window=window,
                                  ring=ring)
        want = ra.decode_attention(_j(q), _j(k), _j(v), jnp.int32(pos),
                                   window=window, ring=ring)
        assert_close(got, want, F32, f"decode pos {pos}")


def _attn_params(rng, d=16, hq=4, hkv=2, dh=8, bias=True):
    p = {"wq": _f(rng, d, hq * dh, scale=0.3),
         "wk": _f(rng, d, hkv * dh, scale=0.3),
         "wv": _f(rng, d, hkv * dh, scale=0.3),
         "wo": _f(rng, hq * dh, d, scale=0.3)}
    if bias:
        p |= {"bq": _f(rng, hq * dh), "bk": _f(rng, hkv * dh),
              "bv": _f(rng, hkv * dh)}
    return p


@pytest.mark.parametrize("window,smax", [(0, 12), (4, 4), (16, 12)])
def test_run_attention_prefill_and_decode_with_caches(window, smax):
    """Prefill seeds a cache (a ring shorter than the 8-token prompt when
    ``smax`` = window = 4), then decode writes slot ``pos % smax``."""
    rng = _rng(5)
    p = _attn_params(rng)
    x, xs = _f(rng, 2, 8, 16), _f(rng, 2, 1, 16)
    kw = dict(cfg_heads=4, cfg_kv=2, head_dim=8, rope_theta=1e4,
              window=window)
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: _j(v) for k, v in p.items()}
    got, none = ta.run_attention(tp, _t(x), **kw)
    want, _ = _jit(ra.run_attention, jp, _j(x), **kw)
    assert none is None
    assert_close(got, want, F32, "self-attention")
    zero = np.zeros((2, smax, 2, 8), np.float32)
    tc = {"k": _t(zero), "v": _t(zero)}
    jc = {"k": _j(zero), "v": _j(zero)}
    got, tc = ta.run_attention(tp, _t(x), cache=tc, **kw)
    attn = jax.jit(lambda p, x, c, pos: ra.run_attention(p, x, cache=c,
                                                         pos=pos, **kw))
    want, jc = attn(jp, _j(x), jc, None)
    assert_close(got, want, F32, "prefill")
    for name in ("k", "v"):
        assert_close(tc[name], jc[name], F32, f"prefill cache {name}")
    for pos in (8, 9):
        got, tc = ta.run_attention(tp, _t(xs), cache=tc, pos=pos, **kw)
        want, jc = attn(jp, _j(xs), jc, jnp.int32(pos))
        assert_close(got, want, F32, f"decode {pos}")
        for name in ("k", "v"):
            assert_close(tc[name], jc[name], F32, f"decode cache {name}")


# ---------------------------------------------------------------------------
# moe.py
# ---------------------------------------------------------------------------

def test_moe_capacity():
    for args in ((1024, 8, 2, 1.25), (4, 8, 2, 4.0), (16, 4, 1, 0.25),
                 (12, 4, 2, 4.0), (543, 8, 2, 4.0)):
        assert tmoe.moe_capacity(*args) == rmoe.moe_capacity(*args)


def _moe_params(rng, d=8, f=12, e=4, router_scale=1.0):
    return {"router": _f(rng, d, e, scale=router_scale),
            "w_gate": _f(rng, e, d, f, scale=0.3),
            "w_up": _f(rng, e, d, f, scale=0.3),
            "w_down": _f(rng, e, f, d, scale=0.3)}


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf,group", [(0.25, 1024), (1.0, 8), (4.0, 1024)])
def test_moe_ffn_drops_tokens_as_the_reference(top_k, cf, group):
    """cf = 0.25 keeps 4 of up to 32 or 64 assignments per expert (tokens
    dropped); group = 8 splits the 32 tokens into 4 groups."""
    rng = _rng(6)
    p = _moe_params(rng)
    x = _f(rng, 2, 16, 8)
    kw = dict(num_experts=4, top_k=top_k, capacity_factor=cf,
              group_size=group)
    got, aux = tmoe.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x), **kw)
    want, waux = _jit(rmoe.moe_ffn, {k: _j(v) for k, v in p.items()},
                      _j(x), **kw)
    assert_close(got, want, F32, "moe y")
    assert_close(aux, waux, F32, "moe aux")
    if cf == 0.25:   # some tokens got no expert at all (dropped)
        assert int((np.abs(np.asarray(want)).sum(-1) == 0).sum()) > 0


def test_moe_ffn_breaks_router_ties_by_expert_index():
    """A zero router gives every expert the same probability: the stable
    sort takes the lowest indices, as ``lax.top_k`` does."""
    rng = _rng(7)
    p = _moe_params(rng)
    p["router"] = np.zeros_like(p["router"])
    x = _f(rng, 1, 8, 8)
    for top_k in (1, 2):
        kw = dict(num_experts=4, top_k=top_k, capacity_factor=4.0)
        got, aux = tmoe.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x),
                                **kw)
        want, waux = _jit(rmoe.moe_ffn, {k: _j(v) for k, v in p.items()},
                          _j(x), **kw)
        assert_close(got, want, F32, f"tie top-{top_k}")
        assert_close(aux, waux, F32)


def test_moe_ffn_in_bf16_keeps_the_router_in_f32():
    rng = _rng(8)
    p = _moe_params(rng)
    x = _f(rng, 2, 4, 8)
    tp = {k: _t(v, torch.float32 if k == "router" else torch.bfloat16)
          for k, v in p.items()}
    jp = {k: _j(v, jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in p.items()}
    kw = dict(num_experts=4, top_k=2, capacity_factor=4.0)
    got, aux = tmoe.moe_ffn(tp, _t(x, torch.bfloat16), **kw)
    want, waux = _jit(rmoe.moe_ffn, jp, _j(x, jnp.bfloat16), **kw)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert_close(got, want, dict(rtol=2 ** -6, atol=2 ** -6), "moe bf16")
    assert_close(aux, waux, F32)


# ---------------------------------------------------------------------------
# ssm.py
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, b=2, l=16, h=3, p=4, n=5):
    x = _f(rng, b, l, h, p)
    dt = np.log1p(np.exp(_f(rng, b, l, h))).astype(np.float32)
    return x, dt, _f(rng, h, scale=0.5), _f(rng, b, l, n), _f(rng, b, l, n)


def test_segsum_and_ssd_chunked_against_naive_ssd():
    rng = _rng(9)
    z = _f(rng, 2, 6)
    assert_close(tssm._segsum(_t(z)), rssm._segsum(_j(z)), F32, "segsum")
    args = _ssd_inputs(rng)
    y, s = tssm.ssd_chunked(*map(_t, args), chunk=4)
    wy, ws = _jit(rssm.ssd_chunked, *map(_j, args), chunk=4)
    ny, ns = tssm.naive_ssd(*map(_t, args))
    ry, rs = _jit(rssm.naive_ssd, *map(_j, args))
    for got, want in ((y, wy), (s, ws), (y, ny), (s, ns), (ny, ry),
                      (ns, rs)):
        assert_close(got, want, dict(rtol=1e-4, atol=1e-4), "ssd")


def test_ssd_decode_step_continues_the_recurrence():
    rng = _rng(10)
    x, dt, a_log, b, c = _ssd_inputs(rng, l=1)
    state = _f(rng, 2, 3, 4, 5)
    got = tssm.ssd_decode_step(_t(state), _t(x[:, 0]), _t(dt[:, 0]),
                               _t(a_log), _t(b[:, 0]), _t(c[:, 0]))
    want = rssm.ssd_decode_step(_j(state), _j(x[:, 0]), _j(dt[:, 0]),
                                _j(a_log), _j(b[:, 0]), _j(c[:, 0]))
    for g, w in zip(got, want):
        assert_close(g, w, F32, "ssd decode")


@pytest.mark.parametrize("l", [16, 11, 1])
def test_mamba2_block_unpadded_padded_and_decoding(l):
    """l = 16: two whole chunks; l = 11: padded to 16 with dt = 0 steps;
    l = 1 with a cache: the one-token decode branch."""
    ref_cfg = ref_get_config("mamba2-130m", smoke=True)
    cfg = get_config("mamba2-130m", smoke=True)
    rng = _rng(11)
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = {"in_proj": _f(rng, d, 2 * di + 2 * n + h, scale=0.2),
         "conv_w": _f(rng, 4, di + 2 * n, scale=0.2),
         "dt_bias": _f(rng, h, scale=0.1), "a_log": _f(rng, h, scale=0.1),
         "d_skip": _f(rng, h), "norm": _f(rng, di),
         "out_proj": _f(rng, di, d, scale=0.2)}
    u = _f(rng, 2, l, d)
    cache = {"conv": _f(rng, 2, 3, di + 2 * n),
             "state": _f(rng, 2, h, cfg.ssm_headdim, n, scale=0.1)}
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: _j(v) for k, v in p.items()}
    if l > 1:
        got, none = tssm.mamba2_block(tp, cfg, _t(u))
        want, _ = jax.jit(lambda p, u: rssm.mamba2_block(p, ref_cfg, u))(
            jp, _j(u))
        assert none is None
        assert_close(got, want, F32, "mamba2 forward")
    tc = {k: _t(v) for k, v in cache.items()}
    got, tc = tssm.mamba2_block(tp, cfg, _t(u), tc)
    want, jc = jax.jit(lambda p, u, c: rssm.mamba2_block(p, ref_cfg, u, c))(
        jp, _j(u), {k: _j(v) for k, v in cache.items()})
    assert_close(got, want, F32, "mamba2 with cache")
    for k in ("conv", "state"):
        assert_close(tc[k], jc[k], F32, f"mamba2 cache {k}")
    split = tssm.mamba2_split(cfg, _t(_f(rng, 1, 2 * di + 2 * n + h)))
    assert [s.shape[-1] for s in split] == [di, di, n, n, h]
    specs = tssm.mamba2_cache_init(cfg, 2, torch.float32,
                                   torch.device("cpu"))
    want = rssm.mamba2_cache_init(ref_cfg, 2, jnp.float32)
    for k in ("conv", "state"):
        assert tuple(specs[k].shape) == want[k].shape
        assert not bool(specs[k].any())


# ---------------------------------------------------------------------------
# stubs.py
# ---------------------------------------------------------------------------

def test_frontend_stubs_have_the_references_shapes_dtypes_and_masks():
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(get_config("internvl2-26b", smoke=True),
                              param_dtype="bfloat16")
    ref_cfg = dataclasses.replace(
        ref_get_config("internvl2-26b", smoke=True), param_dtype="bfloat16")
    fe, mask = stubs.vision_stub_embeds(cfg, torch.Generator().manual_seed(3),
                                        2, 12, 4, cpu)
    wfe, wmask = jax.eval_shape(
        lambda k: rl_stub_vision(ref_cfg, k), jax.random.PRNGKey(3))
    assert tuple(fe.shape) == wfe.shape and fe.dtype == torch.bfloat16
    real = rl_stub_vision(ref_cfg, jax.random.PRNGKey(3))[1]
    assert torch.equal(mask, torch.as_tensor(np.array(real)))
    assert float(fe.float().std()) == pytest.approx(0.02, rel=0.1)
    cfg_a = get_config("musicgen-medium", smoke=True)
    fa = stubs.audio_stub_embeds(cfg_a, torch.Generator().manual_seed(3), 2,
                                 12, cpu)
    assert fa.shape == (2, 12, cfg_a.d_model) and fa.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            stubs.audio_stub_embeds(cfg_a, torch.Generator(), 2, 12)


def rl_stub_vision(cfg, key):
    return ref_vision_stub(cfg, key, 2, 12, 4)
