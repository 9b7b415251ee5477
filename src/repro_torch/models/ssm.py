"""Mamba2 (SSD — state-space duality) block, chunked scan + decode step.

Implements the single-group SSD recurrence
    h_t = exp(Δ_t·A) · h_{t-1} + Δ_t · B_t ⊗ x_t        (h: [H, P, N])
    y_t = C_t · h_t + D ⊙ x_t
with the chunked dual form (intra-chunk quadratic + inter-chunk state scan),
following Dao & Gu 2024 [arXiv:2405.21060]. ``naive_ssd`` is the
step-by-step recurrence oracle used by tests. The state is float32.

A cache passed to :func:`mamba2_block` is consumed: its conv window and
state are overwritten in place with the new ones, and it is returned.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (causal_conv1d, dense_init, normal,
                                        rms_norm)


def _segsum(z: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums.

    z: [..., C] → out[..., i, j] = Σ_{k=j+1..i} z_k  (−inf above diagonal).
    """
    c = z.shape[-1]
    cs = torch.cumsum(z, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=z.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int):
    """Chunked SSD. Shapes:
    x:  [B, L, H, P]   (pre-discretization input)
    dt: [B, L, H]      (positive step sizes, post-softplus)
    a_log: [H]         (A = −exp(a_log) < 0)
    b, c: [B, L, N]    (single group, shared across heads)

    Returns (y [B, L, H, P], final_state [B, H, P, N]). L % chunk == 0.
    """
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    nc = l // chunk
    a = -torch.exp(a_log.float())                               # [H]

    xf = x.float() * dt[..., None]                              # Δx
    da = dt.float() * a                                         # [B, L, H]

    xc = xf.reshape(bsz, nc, chunk, h, p)
    dac = da.reshape(bsz, nc, chunk, h)
    bc = b.float().reshape(bsz, nc, chunk, n)
    cc = c.float().reshape(bsz, nc, chunk, n)

    da_cum = torch.cumsum(dac, dim=2)                           # [B,nc,C,H]

    # --- intra-chunk (diagonal blocks): y_ij = C_i·B_j · exp(Σ_{j<k<=i} da)
    ldec = torch.exp(_segsum(dac.movedim(3, 2)))                # [B,nc,H,C,C]
    scores = torch.einsum("bzin,bzjn->bzij", cc, bc)            # [B,nc,C,C]
    att = scores[:, :, None] * ldec                             # [B,nc,H,C,C]
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", att, xc)

    # --- chunk summary states: S_z = Σ_j exp(da_cum[-1]−da_cum[j])·B_j⊗x_j
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)     # [B,nc,C,H]
    states = torch.einsum("bzcn,bzch,bzchp->bzhpn", bc, decay_states, xc)

    # --- inter-chunk recurrence
    chunk_decay = torch.exp(da_cum[:, :, -1])                   # [B,nc,H]
    s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    s_prevs = []
    for z in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, z][..., None, None] + states[:, z]
    s_prevs = torch.stack(s_prevs, dim=1)                       # [B,nc,H,P,N]

    # --- inter-chunk contribution: y_i += C_i · exp(da_cum[i]) · S_prev
    state_decay = torch.exp(da_cum)                             # [B,nc,C,H]
    y_off = torch.einsum("bzcn,bzhpn,bzch->bzchp", cc, s_prevs, state_decay)

    y = (y_diag + y_off).reshape(bsz, l, h, p)
    return y.to(x.dtype), s


def naive_ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor):
    """Step-by-step recurrence oracle (tests only; O(L) sequential)."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())
    s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        bt, ct = b[:, t].float(), c[:, t].float()
        dec = torch.exp(dtt * a)                                   # [B,H]
        s = (s * dec[..., None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dtt, xt, bt))
        ys.append(torch.einsum("bn,bhpn->bhp", ct, s))
    return torch.stack(ys, dim=1).to(x.dtype), s


def ssd_decode_step(state: torch.Tensor, xt: torch.Tensor,
                    dtt: torch.Tensor, a_log: torch.Tensor, bt: torch.Tensor,
                    ct: torch.Tensor):
    """One-token SSD update. state: [B,H,P,N]; xt: [B,H,P]; dtt: [B,H];
    bt, ct: [B,N]. Returns (y [B,H,P], new_state)."""
    a = -torch.exp(a_log.float())
    dec = torch.exp(dtt.float() * a)
    state = (state * dec[..., None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dtt.float(), xt.float(),
                            bt.float()))
    y = torch.einsum("bn,bhpn->bhp", ct.float(), state)
    return y.to(xt.dtype), state


# ---------------------------------------------------------------------------
# Full Mamba2 block (projections + conv + SSD + gated norm)
# ---------------------------------------------------------------------------

def mamba2_split(cfg, zxbcdt: torch.Tensor):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z, x, b, c, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    return z, x, b, c, dt


def mamba2_block(params, cfg, u: torch.Tensor,
                 cache: Optional[dict] = None):
    """u: [B, L, D] → (y [B, L, D], cache_or_None).

    cache = {"conv": [B, k-1, d_conv], "state": [B, H, P, N]} for decode
    (L == 1) and prefill seeding, updated in place and returned; None for
    a training forward.
    """
    bsz, l, _ = u.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim

    zxbcdt = u @ params["in_proj"]
    z, x, b, c, dt = mamba2_split(cfg, zxbcdt)

    xbc = torch.cat([x, b, c], dim=-1)
    conv_cache = None if cache is None else cache["conv"]
    xbc, new_conv = causal_conv1d(xbc, params["conv_w"], conv_cache)
    xbc = F.silu(xbc)
    x, b, c = torch.split(xbc, [di, n, n], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"].float())      # [B,L,H]
    xh = x.reshape(bsz, l, h, p)

    if cache is not None and l == 1:
        y, new_state = ssd_decode_step(
            cache["state"], xh[:, 0], dt[:, 0], params["a_log"],
            b[:, 0], c[:, 0])
        y = y[:, None]                                     # [B,1,H,P]
    else:
        # pad L to a chunk multiple with dt=0 steps: exp(0·A)=1 decay and
        # 0·B·x input leave the final state exact; padded outputs sliced off
        pad = (-l) % cfg.ssm_chunk
        if pad:
            y, new_state = ssd_chunked(
                F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                params["a_log"], F.pad(b, (0, 0, 0, pad)),
                F.pad(c, (0, 0, 0, pad)), cfg.ssm_chunk)
            y = y[:, :l]
        else:
            y, new_state = ssd_chunked(xh, dt, params["a_log"], b, c,
                                       cfg.ssm_chunk)

    y = y + xh * params["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, l, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"],
                 cfg.norm_eps)
    out = y @ params["out_proj"]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)
    return out, cache


def mamba2_init(generator, cfg, dtype: torch.dtype, device: torch.device,
                lead: tuple = ()):
    """One Mamba2 block's params (``lead`` stacks layers)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    e_out = 2 * di + 2 * n + h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(generator, d, e_out, dtype, device, lead),
        "conv_w": (normal(generator, (*lead, cfg.ssm_conv, di + 2 * n),
                          device) * 0.2).to(dtype).to(device),
        "dt_bias": torch.zeros((*lead, h), **f32),
        "a_log": torch.zeros((*lead, h), **f32),           # A = −1
        "d_skip": torch.ones((*lead, h), **f32),
        "norm": torch.ones((*lead, di), dtype=dtype, device=device),
        "out_proj": dense_init(generator, di, d, dtype, device, lead),
    }


def mamba2_cache_init(cfg, batch: int, dtype: torch.dtype,
                      device: torch.device, lead: tuple = ()):
    """Zeroed caches (``lead`` stacks layers); real zeros, not a broadcast
    view, since decode writes each layer's slice in place."""
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=dtype, device=device),
        "state": torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_headdim,
                              n), dtype=torch.float32, device=device),
    }
