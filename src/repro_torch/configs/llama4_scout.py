"""llama4-scout-17b-a16e — Llama-4 Scout (MoE 16e top-1)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Treated as full attention (iRoPE chunked attention not reproduced) →
long_500k cell skipped; see DESIGN §4.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    num_experts=16, num_experts_per_tok=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E [unverified]",
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=16,
    num_experts=4, num_experts_per_tok=1, capacity_factor=4.0, param_dtype="float32",
)
