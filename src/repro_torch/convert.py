"""Parameters from the reference's JAX pytree.

The caller converts the pytree to numpy arrays first (for example with
``jax.tree.map(np.asarray, params)``); this module needs neither JAX nor
``ml_dtypes``.  The JAX layout stacks every layer on a leading axis L,
``dense_layers/{ln1, ln2, attn/{wq, wk, wv, wo}, ffn/{wi_gate, wi_up, wo}}``,
with weights stored [in, out] — the port's layout too.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.common import ModelConfig
from .models.transformer import Transformer


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no bf16; float32 is exact
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Transformer:
    """A :class:`Transformer` holding the JAX model's parameters."""
    device = resolve_device(device)
    params = Transformer(cfg, None, device)

    def put(dst: torch.nn.Parameter, src: Any) -> None:
        t = _tensor(src)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
        dst.data.copy_(t.to(dtype=dst.dtype))

    put(params.embed, np_tree["embed"])
    put(params.ln_f, np_tree["ln_f"])
    if params.head is not None:
        put(params.head, np_tree["head"])
    stacked = np_tree["dense_layers"]
    for i, layer in enumerate(params.layers):
        put(layer.ln1, stacked["ln1"][i])
        put(layer.ln2, stacked["ln2"][i])
        for name in ("wq", "wk", "wv", "wo"):
            put(getattr(layer.attn, name), stacked["attn"][name][i])
        for name in ("wi_gate", "wi_up", "wo"):
            put(getattr(layer.ffn, name), stacked["ffn"][name][i])
    return params
