"""The port's serving loop (``repro_torch.launch.serve``) against the
reference's, and its CLI on the CPU.

``generate`` on the reference's SMOKE params and the same prompts gives the
reference loop's greedy tokens exactly (mixtral past its SWA window, and
mamba2), and each step's logits to float32 summation order
(``_torch_lm.F32``); the reference's smallest top-1/top-2 logit gap over
the run is asserted to be far above that tolerance, so equal argmaxes are
not luck. The CLI is the twin of ``tests/test_cli_serve.py`` with
``--device cpu``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import F32, assert_close, configs, ref_params
from conftest import SRC
from repro.models import model as ref_model
from repro_torch import convert
from repro_torch.launch.serve import generate

torch.set_num_threads(1)


def _ref_loop(cfg, params, prompts, gen):
    """The loop of ``repro.launch.serve.main``."""
    prefill = jax.jit(lambda p, t, c: ref_model.prefill(cfg, p, t, c))
    decode = jax.jit(
        lambda p, c, t, pos: ref_model.decode_step(cfg, p, c, t, pos))
    cache = ref_model.init_cache(cfg, prompts.shape[0],
                                 prompts.shape[1] + gen)
    logits, cache = prefill(params, prompts, cache)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out, kept = [tok], [logits]
    for i in range(gen - 1):
        logits, cache = decode(params, cache, tok,
                               jnp.int32(prompts.shape[1] + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(tok)
        kept.append(logits)
    return np.asarray(jnp.stack(out, axis=1)), [np.asarray(x) for x in kept]


@pytest.mark.parametrize("arch,prompt_len,gen", [
    ("mixtral-8x7b", 32, 16),      # a 32-slot SWA ring, decoded past it
    ("mamba2-130m", 16, 8)])
def test_generate_gives_the_reference_loops_greedy_tokens(arch, prompt_len,
                                                          gen):
    ref_cfg, cfg = configs(arch)
    params = ref_params(ref_cfg)
    prompts = np.random.default_rng(1).integers(
        0, ref_cfg.vocab_size, (2, prompt_len)).astype(np.int32)
    want_tokens, want_logits = _ref_loop(ref_cfg, params, prompts, gen)
    out = generate(cfg, convert.lm_params(params, "cpu"),
                   torch.as_tensor(prompts).long(), gen, "cpu",
                   keep_logits=True)
    np.testing.assert_array_equal(out.tokens.numpy(), want_tokens)
    assert len(out.logits) == len(out.seconds) == gen
    for step, (got, want) in enumerate(zip(out.logits, want_logits)):
        assert_close(got, want, F32, f"step {step}")
    top2 = np.sort(np.stack(want_logits), axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    assert margin > 50 * F32["atol"], margin


def test_serve_cli_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve",
         "--arch", "mixtral-8x7b", "--batch", "2", "--prompt-len", "16",
         "--gen", "8", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "generated=8 tokens" in p.stdout
    assert "sample generations" in p.stdout
    rows = [ln for ln in p.stdout.splitlines() if ln.startswith("   [")]
    assert len(rows) == 2 and all(len(json.loads(r)) == 8 for r in rows)
