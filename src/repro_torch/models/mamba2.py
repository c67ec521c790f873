"""Mamba2 dimensions (the part of ``repro.models.mamba2`` the port needs so
far).

``mamba_dims`` sizes a Mamba2 block; the GEMM-site analyzer
(``repro_torch.core.offload.model_gemm_sites``) uses it for the zamba2
hybrid's projections.  The Mamba2 (SSD) block itself and the zamba2
hybrid wiring wait for ROADMAP item A4.5; until then ``build_model``
refuses the hybrid family.
"""
from __future__ import annotations

from .common import ModelConfig


def mamba_dims(cfg: ModelConfig):
    """(d_inner, heads, head width, state size) of ``cfg``'s Mamba2 block."""
    d_inner = 2 * cfg.d_model
    nh = cfg.n_heads
    hp = d_inner // nh
    ds = cfg.ssm_state
    return d_inner, nh, hp, ds
