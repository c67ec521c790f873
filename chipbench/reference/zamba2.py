"""Zamba2 (arXiv:2411.15242) as the port builds it, in plain float32
PyTorch: Mamba-2 layers, and one shared attention block applied after
every ``attn_every``-th of them.  The port's departures from the
published model are listed in ``configs/zamba2-1.2b.json``
(``departures``) and followed here:

    Mamba-2 layer, xn = RMSNorm(x):
      z | xBC | dt_raw = xn W_in            (d_inner | d_inner + 2 ds | nh)
      xBC = silu(causal depthwise conv of width K over xBC, + bias)
      x_s | B | C = xBC                     (heads of hp | ds | ds)
      dt = softplus(dt_raw + dt_bias), a = exp(-dt exp(A_log))
      S_t = a_t S_{t-1} + dt_t x_t^T B_t,   y_t = S_t C_t + D x_t
      x += (y * silu(z)) W_out
    shared block: x += Attn(RMSNorm(x)) (causal, RoPE on half-split
      pairs), x += SwiGLU(RMSNorm(x))
    logits = RMSNorm(x) Whead

The weights come as drawn, in the served dtype; each is upcast to float32
where it is used.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .linear_scan import ssd
from .plain import (FLOAT32, ParamSpec, Precision, fan_in, model_dtype,
                    normal, rms_norm,
                    uniform)

F32 = torch.float32


def dims(cfg: Dict):
    dv = cfg["derived"]
    return dv["d_inner"], dv["mamba_heads"], dv["mamba_head_dim"], \
        cfg["model"]["ssm_state"]


def tiny(cfg: Dict) -> Dict:
    """``cfg``, whose ``model`` the tests have set to the port's tiny
    sizes, with ``derived`` as the port derives it: Mamba2 twice as wide
    as d, split into n_heads heads."""
    m = cfg["model"]
    d, H = m["d_model"], m["n_heads"]
    apps = m["n_layers"] // m["attn_every"]
    cfg["derived"] = {"d_inner": 2 * d, "mamba_heads": H,
                      "mamba_head_dim": 2 * d // H,
                      "attention_applications": apps}
    return cfg


def medium(cfg: Dict) -> Dict:
    """``cfg`` at a CPU size at which the control's rounding passes the
    cell's limit: the full vocabulary and dtype, 12 layers of width 256,
    a shared block after every third."""
    cfg["model"].update(n_layers=12, d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, head_dim=64, attn_every=3)
    cfg["derived"].update(d_inner=512, mamba_heads=4, mamba_head_dim=128,
                          attention_applications=4)
    return cfg


def param_specs(cfg: Dict) -> List[ParamSpec]:
    m = cfg["model"]
    W = model_dtype(cfg)      # the served dtype: bfloat16 at full size
    d, f, V = m["d_model"], m["d_ff"], m["vocab"]
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    d_inner, nh, _, ds = dims(cfg)
    K = m["conv_kernel"]
    conv_dim = d_inner + 2 * ds
    specs = [ParamSpec("embed", (V, d), W, normal(0.02)),
             ParamSpec("ln_f", (d,), F32, uniform(0.8, 1.2)),
             ParamSpec("head", (d, V), W, fan_in((d, V)))]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        n_in = 2 * d_inner + 2 * ds + nh
        specs += [ParamSpec(p + "ln", (d,), F32, uniform(0.8, 1.2)),
                  ParamSpec(p + "in_proj", (d, n_in), W, fan_in((d, n_in))),
                  ParamSpec(p + "conv_w", (K, conv_dim), W, normal(0.5)),
                  ParamSpec(p + "conv_b", (conv_dim,), W, normal(0.1)),
                  ParamSpec(p + "A_log", (nh,), F32, uniform(0.0, 2.77)),
                  ParamSpec(p + "D", (nh,), F32, uniform(0.5, 1.5)),
                  ParamSpec(p + "dt_bias", (nh,), F32, uniform(-6.9, -2.3)),
                  ParamSpec(p + "out_proj", (d_inner, d), W,
                            fan_in((d_inner, d)))]
    s = "shared."
    specs += [ParamSpec(s + "ln1", (d,), F32, uniform(0.8, 1.2)),
              ParamSpec(s + "ln2", (d,), F32, uniform(0.8, 1.2)),
              ParamSpec(s + "attn.wq", (d, H * hd), W, fan_in((d, 1))),
              ParamSpec(s + "attn.wk", (d, Hkv * hd), W, fan_in((d, 1))),
              ParamSpec(s + "attn.wv", (d, Hkv * hd), W, fan_in((d, 1))),
              ParamSpec(s + "attn.wo", (H * hd, d), W,
                        fan_in((H * hd, 1))),
              ParamSpec(s + "ffn.wi_gate", (d, f), W, fan_in((d, f))),
              ParamSpec(s + "ffn.wi_up", (d, f), W, fan_in((d, f))),
              ParamSpec(s + "ffn.wo", (f, d), W, fan_in((f, d)))]
    return specs


def _mamba(P, i: int, cfg: Dict, x, prec: Precision):
    m = cfg["model"]
    d_inner, nh, hp, ds = dims(cfg)
    K = m["conv_kernel"]
    B, T, _ = x.shape
    p = f"layers.{i}."

    def g(name):
        return P[p + name].float()

    xn = rms_norm(x, g("ln"), m["rms_eps"])
    zxbcdt = prec.mm(xn, g("in_proj"))
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * ds]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * ds:]
    w = g("conv_w")                                          # (K, C)
    padded = torch.cat([xbc.new_zeros(B, K - 1, xbc.shape[-1]), xbc], 1)
    conv = sum(padded[:, j:j + T] * w[j] for j in range(K)) + g("conv_b")
    xbc = F.silu(conv)
    xs = xbc[..., :d_inner].reshape(B, T, nh, hp)
    Bm = xbc[..., d_inner:d_inner + ds]
    Cm = xbc[..., d_inner + ds:]
    dt = F.softplus(dt_raw + g("dt_bias"))
    loga = -dt * torch.exp(g("A_log"))
    y = ssd(xs, Bm, Cm, loga, dt) + g("D")[:, None] * xs
    y = y.reshape(B, T, d_inner) * F.silu(z)
    return x + prec.mm(y, g("out_proj"))


def _rope(x, theta: float):
    """x: (B, T, H, hd); positions 0..T-1; pairs (i, i + hd/2)."""
    T, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1)


def _shared(P, cfg: Dict, x, prec: Precision):
    m = cfg["model"]
    H, Hkv, hd, eps = m["n_heads"], m["n_kv_heads"], m["head_dim"], \
        m["rms_eps"]
    B, T, _ = x.shape

    def g(name):
        return P["shared." + name].float()

    h = rms_norm(x, g("ln1"), eps)
    q = _rope(prec.mm(h, g("attn.wq")).reshape(B, T, H, hd), m["rope_theta"])
    k = _rope(prec.mm(h, g("attn.wk")).reshape(B, T, Hkv, hd),
              m["rope_theta"])
    v = prec.mm(h, g("attn.wv")).reshape(B, T, Hkv, hd)
    rep = H // Hkv
    k, v = (a.repeat_interleave(rep, dim=2) for a in (k, v))
    att = torch.einsum("bthd,bshd->bhts", q, k) / hd ** 0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, H * hd)
    x = x + prec.mm(o, g("attn.wo"))
    h = rms_norm(x, g("ln2"), eps)
    a = F.silu(prec.mm(h, g("ffn.wi_gate"))) * prec.mm(h, g("ffn.wi_up"))
    return x + prec.mm(a, g("ffn.wo"))


def hidden(P: Dict[str, torch.Tensor], cfg: Dict, ids: torch.Tensor,
           prec: Precision = FLOAT32):
    m = cfg["model"]
    x = P["embed"][ids].float()
    for i in range(m["n_layers"]):
        x = _mamba(P, i, cfg, x, prec)
        if (i + 1) % m["attn_every"] == 0:
            x = _shared(P, cfg, x, prec)
    return rms_norm(x, P["ln_f"].float(), m["rms_eps"])


def logits(P, cfg, ids, prec: Precision = FLOAT32,
           positions: Optional[torch.Tensor] = None):
    """Logits (B, T, V), or at ``positions`` of axis 1 only."""
    h = hidden(P, cfg, ids, prec)
    if positions is not None:
        h = h[:, positions]
    return prec.mm(h, P["head"].float())
