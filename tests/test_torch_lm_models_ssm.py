"""The port's state-space LMs (mamba2, and zamba2's hybrid of Mamba2
layers and one shared attention block) against the JAX reference on the
same weights and tokens.

Each SMOKE architecture's ``forward`` (logits and aux), ``loss_fn`` value,
``prefill`` (last logits, conv windows and f32 SSD states, and zamba2's
per-site K/V) and ``decode_step`` (logits and caches) equal the jitted
reference's to float32 summation order (``_torch_lm.F32``); mamba2 also
with its FULL config's tied embeddings; and one bfloat16 case per family
at ``_torch_lm.BF16``. The SMOKE prompts (11 tokens, chunk 8) take
``mamba2_block``'s padded branch, and decode its one-token branch.
"""

import pytest
import torch

from _torch_lm import BF16, parity
from repro.configs import get_config as ref_get_config

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_smoke_ssm_arch_matches_the_reference(arch):
    got, _ = parity(arch)
    cfg = ref_get_config(arch, smoke=True)
    assert tuple(got["logits"].shape) == (2, 12, cfg.padded_vocab)
    assert got["cache_decode"]["layers"]["state"].dtype == torch.float32


def test_mamba2_with_its_full_configs_tied_embeddings():
    assert ref_get_config("mamba2-130m").tie_embeddings
    assert not ref_get_config("mamba2-130m", smoke=True).tie_embeddings
    parity("mamba2-130m", tie_embeddings=True)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_bf16_per_family_matches_the_reference(arch):
    got, _ = parity(arch, tol=BF16, param_dtype="bfloat16")
    assert got["logits"].dtype == torch.bfloat16
    assert got["cache_decode"]["layers"]["conv"].dtype == torch.bfloat16
    assert got["cache_decode"]["layers"]["state"].dtype == torch.float32
