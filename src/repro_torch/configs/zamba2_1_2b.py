"""zamba2-1.2b — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]  38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Shared transformer block applied every 6 mamba layers
(Zamba2-style; per-application LoRA simplified to shared weights —
DESIGN.md section 5)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm_state=64, attn_every=6, conv_kernel=4,
)
