"""llama4-maverick-400b-a17b — MoE 128e top-1 (+1 shared expert), early
fusion dropped (text backbone per assignment).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    moe=True, n_experts=128, top_k=1, n_shared_experts=1,
    moe_d_ff=8192, first_k_dense=0, dense_d_ff=0,
)
