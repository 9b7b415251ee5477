"""Shared neural-net building blocks (plain functions over tensors).

The reference's ``models/layers.py`` with its names and casts: norms and
RoPE compute in float32 and cast back, initializers draw float32 normals
from a ``torch.Generator`` and cast to the parameter dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, computed in f32 regardless of input dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x·Wg) ⊙ (x·Wu) )."""
    g = F.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2] (f32)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate split halves (not interleaved pairs). x: [..., S, H, Dh];
    positions: broadcastable to [..., S]."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                  # [dh/2]
    ang = positions[..., None].float() * inv               # [..., S, dh/2]
    sin = torch.sin(ang)[..., None, :]                     # [..., S, 1, dh/2]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal(generator: Optional[torch.Generator], shape,
           device: torch.device) -> torch.Tensor:
    """Float32 standard normals of ``shape`` drawn from ``generator`` on its
    own device, then moved to ``device``; on the ``meta`` device an empty
    tensor (shapes and dtypes only, no draw)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    gen_dev = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=gen_dev)


def dense_init(generator, d_in: int, d_out: int, dtype: torch.dtype,
               device: torch.device, lead: tuple = ()) -> torch.Tensor:
    """√(2/(d_in+d_out))-scaled normals ``[*lead, d_in, d_out]`` (``lead``
    stacks layers or experts)."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = scale * normal(generator, (*lead, d_in, d_out), device)
    return w.to(dtype).to(device)


def embed_init(generator, vocab: int, dim: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    return (normal(generator, (vocab, dim), device) * 0.02
            ).to(dtype).to(device)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [B, L, C]; w: [k, C].

    Returns (y [B, L, C], new_cache [B, k-1, C]). ``cache`` holds the last
    k−1 inputs from the previous segment (zeros at t=0).
    """
    k, c = w.shape
    b, l, _ = x.shape
    if cache is None:
        cache = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device)
    xx = torch.cat([cache.to(x.dtype), x], dim=1)         # [B, L+k-1, C]
    y = sum(xx[:, i:i + l, :] * w[i][None, None, :] for i in range(k))
    new_cache = xx[:, l:l + k - 1, :]
    return y.to(x.dtype), new_cache
