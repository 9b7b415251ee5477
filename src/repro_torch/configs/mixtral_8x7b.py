"""mixtral-8x7b — Mixtral 8×7B (MoE 8e top-2, SWA 4096) [arXiv:2401.04088; hf].

SWA makes the decode KV cache O(window) → long_500k runs for this arch.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    num_experts=8, num_experts_per_tok=2, sliding_window=4096,
    source="arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1 [hf]",
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=16,
    num_experts=4, num_experts_per_tok=2, sliding_window=32,
    capacity_factor=4.0, param_dtype="float32",
)
