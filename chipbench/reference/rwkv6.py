"""RWKV-6 ("Finch", arXiv:2404.05892) as the port builds it, in plain
float32 PyTorch.  The port's departures from the published model are
listed in ``configs/rwkv6-1.6b-fp32.json`` (``departures``) and followed
here, so both sides compute one function:

    per layer, with xn = RMSNorm(x) and xp its previous token (zero first):
      mix(m) = xn + (xp - xn) * m
      r, k, v = mix(mix_r) Wr, mix(mix_k) Wk, mix(mix_v) Wv
      log w = -exp(w_base + tanh(mix(mix_w) Wa) Wb)
      x += WKV6(r, k, v, w, u) Wo                  (heads of D)
      xn2 = RMSNorm(x), xc = xn2 + (xp2 - xn2) * mix_c
      x += relu(xc Wck)^2 Wcv
    logits = RMSNorm(x) Whead

The weights come as drawn, in the served dtype; each is upcast to float32
where it is used.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .linear_scan import wkv6
from .plain import (FLOAT32, ParamSpec, Precision, fan_in, model_dtype,
                    normal, rms_norm,
                    shift, uniform)

F32 = torch.float32


def tiny(cfg: Dict) -> Dict:
    """``cfg``, whose ``model`` the tests have set to the port's tiny
    sizes, with ``derived`` as the port derives it."""
    m = cfg["model"]
    d = m["d_model"]
    cfg["derived"] = {"head_size": d // m["n_heads"],
                      "decay_lora_rank": max(32, d // 32)}
    return cfg


def medium(cfg: Dict) -> Dict:
    """``cfg`` at a CPU size at which the control's rounding passes the
    cell's limit: the full depth, vocabulary and dtype, width 512 in
    heads of 64."""
    cfg["model"].update(d_model=512, n_heads=8, n_kv_heads=8, d_ff=1792,
                        head_dim=64)
    cfg["derived"].update(head_size=64, decay_lora_rank=32)
    return cfg


def param_specs(cfg: Dict) -> List[ParamSpec]:
    """Every parameter, by the port's names, with the distribution the
    benchmark draws it from."""
    m = cfg["model"]
    W = model_dtype(cfg)      # the served dtype: bfloat16 at full size
    d, f, V, H = m["d_model"], m["d_ff"], m["vocab"], m["n_heads"]
    D, lora = d // H, cfg["derived"]["decay_lora_rank"]
    specs = [ParamSpec("embed", (V, d), W, normal(0.02)),
             ParamSpec("ln_f", (d,), F32, uniform(0.8, 1.2)),
             ParamSpec("head", (d, V), W, fan_in((d, V)))]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        specs += [ParamSpec(p + "ln1", (d,), F32, uniform(0.8, 1.2)),
                  ParamSpec(p + "ln2", (d,), F32, uniform(0.8, 1.2))]
        specs += [ParamSpec(p + n, (d,), W, uniform(0.0, 1.0))
                  for n in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_c")]
        specs += [ParamSpec(p + n, (d, d), W, fan_in((d, d)))
                  for n in ("wr", "wk", "wv", "wo")]
        specs += [ParamSpec(p + "w_a", (d, lora), W, normal(0.02)),
                  ParamSpec(p + "w_b", (lora, d), W, normal(0.1)),
                  ParamSpec(p + "w_base", (d,), F32, uniform(-7.0, -2.0)),
                  ParamSpec(p + "u", (H, D), F32, normal(0.5)),
                  ParamSpec(p + "ck", (d, f), W, fan_in((d, f))),
                  ParamSpec(p + "cv", (f, d), W, fan_in((f, d)))]
    return specs


def _layer(P, i: int, cfg: Dict, x, prec: Precision):
    m = cfg["model"]
    eps, H = m["rms_eps"], m["n_heads"]
    B, T, d = x.shape
    D = d // H
    p = f"layers.{i}."

    def g(name):
        return P[p + name].float()

    xn = rms_norm(x, g("ln1"), eps)
    xp = shift(xn)

    def mix(name):
        return xn + (xp - xn) * g(name)

    r = prec.mm(mix("mix_r"), g("wr"))
    k = prec.mm(mix("mix_k"), g("wk"))
    v = prec.mm(mix("mix_v"), g("wv"))
    wl = prec.mm(torch.tanh(prec.mm(mix("mix_w"), g("w_a"))), g("w_b"))
    logw = -torch.exp(g("w_base") + wl)

    def heads(a):
        return a.reshape(B, T, H, D)

    o = wkv6(heads(r), heads(k), heads(v), heads(logw), g("u"))
    x = x + prec.mm(o.reshape(B, T, d), g("wo"))
    xn2 = rms_norm(x, g("ln2"), eps)
    xc = xn2 + (shift(xn2) - xn2) * g("mix_c")
    h = torch.square(torch.relu(prec.mm(xc, g("ck"))))
    return x + prec.mm(h, g("cv"))


def hidden(P: Dict[str, torch.Tensor], cfg: Dict, ids: torch.Tensor,
           prec: Precision = FLOAT32):
    """The final normalised hidden states (B, T, d) of ``ids`` (B, T)
    from the zero state."""
    m = cfg["model"]
    x = P["embed"][ids].float()
    for i in range(m["n_layers"]):
        x = _layer(P, i, cfg, x, prec)
    return rms_norm(x, P["ln_f"].float(), m["rms_eps"])


def logits(P, cfg, ids, prec: Precision = FLOAT32,
           positions: Optional[torch.Tensor] = None):
    """Logits (B, T, V), or at ``positions`` of axis 1 only."""
    h = hidden(P, cfg, ids, prec)
    if positions is not None:
        h = h[:, positions]
    return prec.mm(h, P["head"].float())
