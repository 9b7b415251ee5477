"""Model/shape/run configuration dataclasses (the reference's, field for
field; only :attr:`ModelConfig.dtype` returns a ``torch.dtype``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (one instance per assigned arch)."""

    name: str
    family: str                      # dense | moe | hybrid | vlm | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads; 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads

    # attention details
    rope_theta: float = 1e4
    attn_bias: bool = False          # qwen1.5-style QKV bias
    sliding_window: int = 0          # 0 = full attention; >0 = SWA width

    # MLP / head variants
    mlp_type: str = "swiglu"         # swiglu (3 mats) | gelu (2 mats)
    tie_embeddings: bool = False     # lm_head = embedᵀ

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4

    # hybrid (zamba2-style shared attention block cadence)
    attn_every: int = 0              # 0 = no shared block

    # modality frontend stub
    frontend: str = "none"           # none | vision | audio

    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"    # big configs; smoke tests use float32
    remat: bool = True               # checkpoint the layer-scan body
    # √L nested remat: outer scan over G groups × inner scan over L/G
    # layers, both checkpointed → G + L/G live boundary activations instead
    # of L (88-layer granite: 74 GB → ~16 GB/device; EXPERIMENTS §Perf
    # it.6) at the cost of one extra forward recompute.
    nested_remat: bool = True

    # provenance
    source: str = ""                 # citation / hf id [tier]

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so embed/lm_head always TP-shard (standard
        production practice; padded logits are masked to −inf in the loss).
        param_count() stays unpadded — the pad is honest compute overhead
        visible in the MODEL_FLOPS/HLO ratio."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k cell (DESIGN §4 skip rationale)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        Hq, Hkv, Dh = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        n = V * D                                    # embed
        attn = D * Hq * Dh + 2 * D * Hkv * Dh + Hq * Dh * D
        if self.attn_bias:
            attn += (Hq + 2 * Hkv) * Dh
        mats = 3 if self.mlp_type == "swiglu" else 2
        mlp = mats * D * F
        moe_mlp = self.num_experts * mats * D * F + D * self.num_experts
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = (D * (2 * di + 2 * N + H)          # in_proj
                   + self.ssm_conv * (di + 2 * N)    # depthwise conv
                   + 3 * H + di + di * D)            # A_log, D, dt_bias, norm, out_proj
        per_layer = 2 * D  # norms
        if self.family == "moe":
            per_layer += attn + moe_mlp
        elif self.family == "ssm":
            per_layer = D + ssm
        elif self.family == "hybrid":
            per_layer = D + ssm
        else:
            per_layer += attn + mlp
        n += self.num_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            n += attn + mlp + 2 * D                  # one shared block
        n += D                                       # final norm
        if not self.tie_embeddings:
            n += D * V                               # untied lm head
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k of E experts)."""
        if self.family != "moe" or not self.num_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        mats = 3 if self.mlp_type == "swiglu" else 2
        inactive = (self.num_experts - self.num_experts_per_tok) * mats * D * F
        return self.param_count() - self.num_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell from the assignment."""

    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_cells(cfg: ModelConfig) -> list[str]:
    """The shape cells this arch runs (long_500k needs sub-quadratic attn)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        cells.append("long_500k")
    return cells
