"""The port's MoE LMs (mixtral, llama4-scout) against the JAX reference on
the same weights and tokens.

Each SMOKE architecture's ``forward`` (logits and aux), ``loss_fn`` value,
``prefill`` (last logits and cache) and ``decode_step`` (logits and cache)
equal the jitted reference's to float32 summation order
(``_torch_lm.F32``), and mixtral's in bfloat16 at ``_torch_lm.BF16``;
mixtral's SWA ring cache past its window, from a prompt as long as the ring
and from one twice as long, step for step against the reference's decode
loop. ``moe_ffn`` itself (token dropping, top-1/top-2, ties) is held in
``test_torch_lm_layers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (BF16, F32, assert_close, assert_trees_close, configs,
                       parity, ref_params)
from repro.models import model as ref_model
from repro_torch import convert
from repro_torch.models import model as lm

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e"])
def test_smoke_moe_arch_matches_the_reference(arch):
    got, _ = parity(arch)
    assert float(got["aux"]) > 0


def test_bf16_moe_matches_the_reference():
    got, _ = parity("mixtral-8x7b", tol=BF16, param_dtype="bfloat16")
    assert got["logits"].dtype == torch.bfloat16


def _ring(prompt_len, total, cache_len):
    """Reference and port: prefill ``prompt_len`` tokens into a
    ``cache_len`` SWA ring, then decode up to ``total``."""
    ref_cfg, cfg = configs("mixtral-8x7b")        # window 32
    params = ref_params(ref_cfg)
    toks = np.random.default_rng(5).integers(
        0, ref_cfg.vocab_size, (1, total)).astype(np.int32)
    prefill = jax.jit(lambda p, t, c: ref_model.prefill(ref_cfg, p, t, c))
    decode = jax.jit(lambda p, c, t, pos: ref_model.decode_step(
        ref_cfg, p, c, t, pos))
    cache = ref_model.init_cache(ref_cfg, 1, cache_len)
    want_last, cache = prefill(params, toks[:, :prompt_len], cache)
    tp = convert.lm_params(params, "cpu")
    t = torch.as_tensor(toks).long()
    with torch.inference_mode():
        tc = lm.init_cache(cfg, 1, cache_len, "cpu")
        last, tc = lm.prefill(cfg, tp, t[:, :prompt_len], tc)
        assert_close(last, want_last, F32, "ring prefill")
        forward, _ = lm.forward(cfg, tp, t)
        for pos in range(prompt_len, total):
            want, cache = decode(params, cache, toks[:, pos], jnp.int32(pos))
            got, tc = lm.decode_step(cfg, tp, tc, t[:, pos], pos)
            assert_close(got, want, F32, f"ring step {pos}")
            if pos + 1 < total:
                # the reference test's tolerance for decode = forward
                assert_close(got, forward[:, pos], dict(rtol=3e-2, atol=3e-2),
                             f"ring step {pos} = forward")
    assert_trees_close(tc, jax.tree.map(np.asarray, cache), F32, "ring")
    return tc


def test_swa_ring_cache_past_its_window_matches_the_reference():
    tc = _ring(32, 48, 32)
    assert tc["layers"]["k"].shape[2] == 32


def test_swa_ring_cache_from_a_prompt_longer_than_the_ring():
    """A 64-token prompt into a 32-slot ring keeps its last 32 tokens
    (``s % smax == 0``), then decodes past it."""
    _ring(64, 72, 32)
    _, cfg = configs("mixtral-8x7b")
    with pytest.raises(AssertionError):
        with torch.inference_mode():
            lm.prefill(cfg, lm.init_params(cfg, torch.Generator(), "cpu"),
                       torch.zeros((1, 40), dtype=torch.long),
                       lm.init_cache(cfg, 1, 32, "cpu"))
