"""mamba2-130m — Mamba2 SSD, attention-free [arXiv:2405.21060; unverified].

d_inner = 2·768 = 1536, headdim 64 → 24 SSD heads, state 128.
Attention-free → runs long_500k.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, tie_embeddings=True,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-130m [unverified]",
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke", family="ssm",
    num_layers=3, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_headdim=16, ssm_chunk=8, param_dtype="float32",
)
