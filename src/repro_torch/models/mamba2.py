"""Mamba2 (SSD) block (PyTorch port of ``repro.models.mamba2``); the
zamba2 hybrid that wires it lives in ``models.zoo``.

SSD recurrence per head h with scalar decay a_t:
    S_t = a_t * S_{t-1} + dt_t * (x_t outer B_t)     S: (head_p, d_state)
    y_t = S_t @ C_t + D * x_t
a_t = exp(-softplus(dt_raw + bias) * exp(A_log)), input-dependent.

The recurrence is a loop over time in eager PyTorch, as the reference's
is a ``lax.scan`` (it has no kernel for it): the products that do not
depend on the state are taken for a chunk of steps at once, and each step
is one fused multiply-add on the float32 state.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, constant, rms_norm, weight

# Time steps whose inputs and states are held at once: bounds the scan's
# float32 buffers to 2 x B x SCAN_CHUNK x d_inner x d_state.
SCAN_CHUNK = 256


def mamba_dims(cfg: ModelConfig):
    """(d_inner, heads, head width, state size) of ``cfg``'s Mamba2 block."""
    d_inner = 2 * cfg.d_model
    nh = cfg.n_heads
    hp = d_inner // nh
    ds = cfg.ssm_state
    return d_inner, nh, hp, ds


class Mamba2Block(nn.Module):
    """Parameters of one layer (``init_mamba2_block``), weights [in, out];
    ``ln``, ``A_log``, ``D`` and ``dt_bias`` in float32."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        device = gen.device if gen is not None else device
        d = cfg.d_model
        d_inner, nh, _, ds = mamba_dims(cfg)
        K = cfg.conv_kernel
        conv_dim = d_inner + 2 * ds
        self.ln = constant((d,), 1.0, torch.float32, device)
        self.in_proj = weight(gen, (d, 2 * d_inner + 2 * ds + nh), cfg.dtype,
                              device)
        self.conv_w = weight(gen, (K, conv_dim), cfg.dtype, device,
                             scale=0.5)
        self.conv_b = constant((conv_dim,), 0.0, cfg.dtype, device)
        self.A_log = constant((nh,), 0.0, torch.float32, device)
        self.D = constant((nh,), 1.0, torch.float32, device)
        self.dt_bias = constant((nh,), 0.0, torch.float32, device)
        self.out_proj = weight(gen, (d_inner, d), cfg.dtype, device)


def _causal_conv(x, w, b, prev):
    """x: (B,T,C) depthwise causal conv, kernel K.  prev: (B,K-1,C) left
    context (zeros at sequence start).  Returns (y, new_prev): new_prev is
    the last K-1 rows of [prev, x], also when T < K-1."""
    K = w.shape[0]
    T = x.shape[1]
    xp = torch.cat([prev, x], dim=1)
    y = xp[:, 0:T] * w[0]
    for i in range(1, K):               # taps summed in order, as sum() does
        y = y + xp[:, i:i + T] * w[i]
    new_prev = xp[:, -(K - 1):] if K > 1 else prev
    return y + b, new_prev


def _ssd_scan(xs, Bm, Cm, a, dt, S):
    """xs (B,T,nh,hp), Bm / Cm (B,T,ds), a / dt (B,T,nh), all float32; S
    (B,nh,hp,ds) float32.  Returns (y (B,T,nh,hp), S after the last step)."""
    ys = []
    for t0 in range(0, xs.shape[1], SCAN_CHUNK):
        part = slice(t0, t0 + SCAN_CHUNK)
        dBx = torch.einsum("btnp,bts,btn->tbnps", xs[:, part], Bm[:, part],
                           dt[:, part])
        decay = a[:, part].transpose(0, 1)[..., None, None]  # (t,B,nh,1,1)
        states = torch.empty_like(dBx)
        for t in range(dBx.shape[0]):
            S = torch.addcmul(dBx[t], decay[t], S, out=states[t])
        ys.append(torch.einsum("tbnps,bts->btnp", states, Cm[:, part]))
    return torch.cat(ys, dim=1), S.clone()


def mamba2_block(p: Mamba2Block, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[Tuple] = None):
    """x: (B,T,d); state=(conv_prev (B,K-1,C), ssm (B,nh,hp,ds) float32)
    or None for zeros.  Returns (out, new_state)."""
    B, T, _ = x.shape
    d_inner, nh, hp, ds = mamba_dims(cfg)
    K = cfg.conv_kernel
    conv_dim = d_inner + 2 * ds
    if state is None:
        conv_prev = torch.zeros((B, K - 1, conv_dim), dtype=x.dtype,
                                device=x.device)
        S0 = torch.zeros((B, nh, hp, ds), dtype=torch.float32,
                         device=x.device)
    else:
        conv_prev, S0 = state

    xn = rms_norm(x, p.ln, cfg.rms_eps)
    zxbcdt = xn @ p.in_proj
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]              # (B,T,nh)

    xbc, conv_prev = _causal_conv(xbc, p.conv_w, p.conv_b, conv_prev)
    xbc = F.silu(xbc.float())
    xs = xbc[..., :d_inner].reshape(B, T, nh, hp)
    Bm = xbc[..., d_inner:d_inner + ds]                    # (B,T,ds)
    Cm = xbc[..., d_inner + ds:]                           # (B,T,ds)

    dt = F.softplus(dt_raw.float() + p.dt_bias)            # (B,T,nh)
    a = torch.exp(-dt * torch.exp(p.A_log))                # (B,T,nh)

    y, S = _ssd_scan(xs, Bm, Cm, a, dt, S0)
    y = y + p.D[:, None] * xs
    y = y.reshape(B, T, d_inner)
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p.out_proj
    return x + out, (conv_prev.to(x.dtype), S)
