"""rwkv6-1.6b — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, head_dim=64,
)
