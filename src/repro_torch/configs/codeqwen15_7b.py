"""codeqwen1.5-7b — Qwen1.5 arch (MHA kv=32, QKV bias) [hf:Qwen/CodeQwen1.5-7B]."""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416, head_dim=128, attn_bias=True,
    source="hf:Qwen/CodeQwen1.5-7B [hf]",
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=6, num_kv_heads=6,
    d_ff=256, vocab_size=512, head_dim=16, attn_bias=True,
    param_dtype="float32",
)
