"""glm4-9b — GLM-4 (RoPE, GQA kv=2) [hf:THUDM/glm-4-9b]."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552, head_dim=128,
    source="hf:THUDM/glm-4-9b [hf]",
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16, param_dtype="float32",
)
