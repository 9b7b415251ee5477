"""zamba2-1.2b — Zamba2 hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]. Shared block cadence attn_every=6 (approximation of
Zamba2's shared-block scheme; DESIGN §4). Sub-quadratic → runs long_500k.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    attn_every=6,
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B [hf]",
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    ssm_state=16, ssm_headdim=16, ssm_chunk=8, attn_every=2,
    param_dtype="float32",
)
