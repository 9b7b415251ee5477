"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

EnCodec frontend is a stub (conditioning embeddings added to token
embeddings); 4-codebook heads collapsed to one vocab-2048 head
(backbone-only per assignment, DESIGN §4).
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64, frontend="audio",
    source="arXiv:2306.05284; hf:facebook/musicgen-medium [hf]",
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke", family="audio",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16, frontend="audio",
    param_dtype="float32",
)
