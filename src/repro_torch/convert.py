"""Parameters from the reference's JAX pytree.

The caller converts the pytree to numpy arrays first (for example with
``jax.tree.map(np.asarray, params)``); this module needs neither JAX nor
``ml_dtypes``.  The JAX layout stacks every layer on a leading axis L,
with weights stored [in, out] — the port's layout too:

- dense: ``{embed, ln_f, head?, dense_layers/{ln1, ln2, attn/{wq, wk, wv,
  wo}, ffn/{wi_gate, wi_up, wo}}}``;
- rwkv6 (``family == "ssm"``): ``{embed, ln_f, head, layers/{ln1, ln2,
  mix_r, mix_k, mix_v, mix_w, mix_c, wr, wk, wv, wo, w_a, w_b, w_base, u,
  ck, cv}}``.
"""
from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.common import ModelConfig
from .models.rwkv6 import RWKV6
from .models.transformer import Transformer

_RWKV6_LAYER = ("ln1", "ln2", "mix_r", "mix_k", "mix_v", "mix_w", "mix_c",
               "wr", "wk", "wv", "wo", "w_a", "w_b", "w_base", "u", "ck",
               "cv")


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no bf16; float32 is exact
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy


def _put(dst: torch.nn.Parameter, src: Any) -> None:
    t = _tensor(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
    dst.data.copy_(t.to(dtype=dst.dtype))


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Union[Transformer, RWKV6]:
    """The port's parameters of ``cfg``'s family holding the JAX model's:
    an :class:`RWKV6` for ``family == "ssm"``, else a
    :class:`Transformer`."""
    device = resolve_device(device)
    if cfg.family == "ssm":
        params = RWKV6(cfg, None, device)
        stacked = np_tree["layers"]
        for i, layer in enumerate(params.layers):
            for name in _RWKV6_LAYER:
                _put(getattr(layer, name), stacked[name][i])
    else:
        params = Transformer(cfg, None, device)
        stacked = np_tree["dense_layers"]
        for i, layer in enumerate(params.layers):
            _put(layer.ln1, stacked["ln1"][i])
            _put(layer.ln2, stacked["ln2"][i])
            for name in ("wq", "wk", "wv", "wo"):
                _put(getattr(layer.attn, name), stacked["attn"][name][i])
            for name in ("wi_gate", "wi_up", "wo"):
                _put(getattr(layer.ffn, name), stacked["ffn"][name][i])
    _put(params.embed, np_tree["embed"])
    _put(params.ln_f, np_tree["ln_f"])
    if params.head is not None:
        _put(params.head, np_tree["head"])
    return params
