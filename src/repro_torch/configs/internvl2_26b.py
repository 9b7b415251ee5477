"""internvl2-26b — InternVL2 (InternViT + InternLM2-20B backbone)
[arXiv:2404.16821; hf]. ViT frontend is a stub: input_specs supplies
precomputed patch embeddings + mask (backbone-only per assignment).
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553, head_dim=128, frontend="vision",
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B [hf]",
)

SMOKE = ModelConfig(
    name="internvl2-26b-smoke", family="vlm",
    num_layers=3, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16, frontend="vision",
    param_dtype="float32",
)
