"""Parameters from the reference's JAX pytree.

The caller converts the pytree to numpy arrays first (for example with
``jax.tree.map(np.asarray, params)``); this module needs neither JAX nor
``ml_dtypes``.  The port's parameter modules carry the pytree's names,
and the JAX layout stacks each group of layers on a leading axis, with
weights stored [in, out] as the port stores them.  So the port's
parameter ``dense_layers.3.attn.wq`` is the tree's
``["dense_layers"]["attn"]["wq"][3]`` and ``shared.ffn.wo`` is
``["shared"]["ffn"]["wo"]``, for every family:

- transformer: ``{embed, ln_f, head?, dense_layers?, moe_layers? (ffn:
  router, wi_gate, wi_up, wo, shared?), mtp? {proj, block}}``, attention
  GQA ``{wq, wk, wv, wo}`` or MLA ``{wq_a, wq_b, wkv_a, wkv_b, wo}``;
- rwkv6 (``family == "ssm"``): ``{embed, ln_f, head, layers}``;
- zamba2 (``family == "hybrid"``): ``{embed, ln_f, head, layers (Mamba2),
  shared (one transformer block)}``.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .device import DeviceLike, resolve_device
from .models.common import ModelConfig
from .models.rwkv6 import RWKV6
from .models.transformer import Transformer
from .models.zoo import Zamba2


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no bf16; float32 is exact
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy


def _leaves(tree: Mapping[str, Any], prefix: str = "") -> Iterator[
        Tuple[str, Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> nn.Module:
    """The port's parameters of ``cfg``'s family holding the JAX model's:
    an :class:`RWKV6` for ``family == "ssm"``, a :class:`Zamba2` for
    ``"hybrid"``, else a :class:`Transformer`.  Raises ValueError naming
    the parameter whose shape differs, or a tree leaf the port has no
    parameter for."""
    device = resolve_device(device)
    cls = {"ssm": RWKV6, "hybrid": Zamba2}.get(cfg.family, Transformer)
    params = cls(cfg, None, device)
    used = set()
    for name, dst in params.named_parameters():
        parts = name.split(".")
        keys = [k for k in parts if not k.isdigit()]
        src = np_tree
        for key in keys:
            if not isinstance(src, Mapping) or key not in src:
                raise ValueError(f"{name}: no {'.'.join(keys)} in the tree")
            src = src[key]
        used.add(".".join(keys))
        for layer in (int(k) for k in parts if k.isdigit()):
            src = np.asarray(src)[layer]
        t = _tensor(src)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.data.copy_(t.to(dtype=dst.dtype))
    unused = sorted(path for path, _ in _leaves(np_tree) if path not in used)
    if unused:
        raise ValueError(f"tree leaves without a parameter: {unused}")
    return params
