"""granite-34b — IBM Granite-34B-Code (MQA, 4·d GELU MLP) [arXiv:2405.04324; hf]."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128, mlp_type="gelu",
    source="arXiv:2405.04324; hf:ibm-granite/granite-34b-code-base [hf]",
)

SMOKE = ModelConfig(
    name="granite-34b-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=6, num_kv_heads=1,
    d_ff=256, vocab_size=512, head_dim=16, param_dtype="float32",
)
