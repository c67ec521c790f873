"""Model configuration + shared layer primitives (PyTorch port of
``repro.models.common``).

The cast points follow the reference exactly, because they decide bf16
results: ``rms_norm`` casts back to ``x.dtype`` before the weight multiply,
SiLU and RoPE run in float32 and cast afterwards.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # input modality: "tokens" or "embeddings" (audio/vlm backbone stubs)
    input_mode: str = "tokens"
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0         # d_ff of the first_k_dense layers
    # MLA (DeepSeek-V3)
    moe_capacity_factor: float = 1.25   # 8+ = effectively no-drop
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False           # multi-token-prediction auxiliary head
    # SSM / hybrid
    ssm_state: int = 0
    attn_every: int = 0         # Zamba2: shared attention block period
    conv_kernel: int = 4        # mamba2 depthwise conv width
    # numerics
    dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def decay_lora_rank(self) -> int:
        """RWKV6 data-dependent decay LoRA rank (the Finch heuristic)."""
        return max(32, self.d_model // 32)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k+ context (O(1)-state recurrence)?"""
        return self.family in ("ssm", "hybrid")

    @property
    def params_dense(self) -> int:
        """Approximate total parameter count."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":                      # rwkv6
            att = L * (4 * d * d + 2 * d)             # r,k,v,o (+decay lora)
            ffn = L * (2 * d * self.d_ff)
            return emb + att + ffn
        att_out = self.n_heads * self.hd * d
        if self.mla:
            qk = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.qk_rope_dim)
            kv = d * (self.kv_lora_rank + self.qk_rope_dim) + \
                self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim)
            att = L * (qk + kv + self.n_heads * self.v_head_dim * d)
        else:
            att = L * (d * self.n_heads * self.hd
                       + 2 * d * self.n_kv_heads * self.hd + att_out)
        if self.moe:
            n_moe = L - self.first_k_dense
            ffn = (self.first_k_dense * 3 * d * self.dense_d_ff
                   + n_moe * (self.n_experts + self.n_shared_experts)
                   * 3 * d * self.moe_d_ff
                   + n_moe * d * self.n_experts)
        else:
            ffn = L * 3 * d * self.d_ff
        return emb + att + ffn

    @property
    def params_active(self) -> int:
        """Activated parameters per token (MoE-aware)."""
        if not self.moe:
            return self.params_dense
        full = self.params_dense
        n_moe = self.n_layers - self.first_k_dense
        all_experts = n_moe * self.n_experts * 3 * self.d_model * self.moe_d_ff
        act_experts = n_moe * (self.top_k + self.n_shared_experts) * \
            3 * self.d_model * self.moe_d_ff
        return full - all_experts + act_experts

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=min(self.n_layers, 2 if not self.attn_every else 4),
            d_model=64, n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads)),
            head_dim=16, d_ff=128, vocab=256,
            q_lora_rank=32 if self.mla else 0,
            kv_lora_rank=32 if self.mla else 0,
            qk_nope_dim=16 if self.mla else 0,
            qk_rope_dim=8 if self.mla else 0,
            v_head_dim=16 if self.mla else 0,
            n_experts=min(self.n_experts, 4), top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.moe else 0,
            dense_d_ff=128 if self.first_k_dense else 0,
            first_k_dense=min(self.first_k_dense, 1),
            ssm_state=16 if self.ssm_state else 0,
            attn_every=2 if self.attn_every else 0,
            dtype=torch.float32,
        )


# ------------------------------------------------------------- primitives
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions: (...,) int -> (cos, sin): (..., dim/2) float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., T, H, D); cos/sin: (..., T, D/2) broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
           wo: torch.Tensor):
    g = x @ wi_gate
    u = x @ wi_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ wo


def init_dense(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, dtype=torch.float32):
    """Normal init on ``gen``'s device, drawn in float32 and then cast."""
    scale = scale if scale is not None else (1.0 / (shape[0] ** 0.5))
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def weight(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
           device=None, scale: Optional[float] = None) -> nn.Parameter:
    """A frozen parameter: drawn from ``gen`` by :func:`init_dense`, or left
    uninitialised on ``device`` for a caller that fills it
    (``repro_torch.convert``)."""
    if gen is None:
        w = torch.empty(tuple(shape), dtype=dtype, device=device)
    else:
        w = init_dense(gen, shape, scale=scale, dtype=dtype)
    return nn.Parameter(w, requires_grad=False)


def causal_mask(Tq: int, Tk: int, offset: int = 0, device=None):
    """mask[i, j] = True where key j may attend to query i (j <= i+offset)."""
    q = torch.arange(Tq, device=device)[:, None] + offset
    k = torch.arange(Tk, device=device)[None, :]
    return k <= q
