"""phi4-mini-3.8b — Phi-4-mini (RoPE SwiGLU GQA) [arXiv:2412.08905; hf].

24 query heads do not divide the 16-way model axis; partition.py falls back
to replicated attention projections for this arch (DESIGN §5).
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064, head_dim=128, tie_embeddings=True,
    source="arXiv:2412.08905; hf:microsoft/Phi-4-mini-instruct [hf]",
)

SMOKE = ModelConfig(
    name="phi4-mini-3.8b-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16, param_dtype="float32",
)
