"""The port's dense attention-stack LMs (the dense, vision and audio
families) against the JAX reference on the same weights and tokens
(the MoE family is in ``test_torch_lm_models_moe.py``).

Each SMOKE architecture's ``forward`` (logits and MoE aux, with the
frontend stubs where it has a frontend), ``loss_fn`` value, ``prefill`` of
all tokens but the last (last logits and cache) and ``decode_step`` of the
last (logits and cache) equal the jitted reference's to float32 summation
order (``_torch_lm.F32``); where an architecture's FULL config differs from
its SMOKE config in ``mlp_type`` or ``tie_embeddings`` (granite's GELU,
phi4's tied head), the SMOKE config with FULL's variant too; and one
bfloat16 case per family at ``_torch_lm.BF16``, which holds the casts'
placement.
"""

import pytest
import torch

from _torch_lm import BF16, configs, parity
from repro.configs import get_config as ref_get_config
from repro_torch.models import model as lm

torch.set_num_threads(1)

ARCHS = ["granite-34b", "codeqwen1.5-7b", "glm4-9b", "phi4-mini-3.8b",
         "internvl2-26b", "musicgen-medium"]


def _full_variant(arch):
    full, smoke = ref_get_config(arch), ref_get_config(arch, smoke=True)
    return {k: getattr(full, k) for k in ("mlp_type", "tie_embeddings")
            if getattr(full, k) != getattr(smoke, k)}


VARIANTS = [(a, _full_variant(a)) for a in ARCHS if _full_variant(a)]


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_arch_matches_the_reference(arch):
    got, _ = parity(arch)
    cfg = ref_get_config(arch, smoke=True)
    assert tuple(got["logits"].shape) == (2, 12, cfg.padded_vocab)
    assert float(got["aux"]) == 0.0


def test_full_variants_are_granites_gelu_and_phi4s_tied_head():
    assert VARIANTS == [("granite-34b", {"mlp_type": "gelu"}),
                        ("phi4-mini-3.8b", {"tie_embeddings": True})]


@pytest.mark.parametrize("arch,kw", VARIANTS,
                         ids=[a for a, _ in VARIANTS])
def test_smoke_arch_with_its_full_variant_matches_the_reference(arch, kw):
    got, _ = parity(arch, **kw)
    if kw.get("tie_embeddings"):
        _, cfg = configs(arch, **kw)
        assert "lm_head" not in lm.param_specs(cfg)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "internvl2-26b",
                                  "musicgen-medium"])
def test_bf16_per_family_matches_the_reference(arch):
    got, want = parity(arch, tol=BF16, param_dtype="bfloat16")
    assert got["logits"].dtype == torch.bfloat16
    assert want["logits"].dtype.name == "bfloat16"
