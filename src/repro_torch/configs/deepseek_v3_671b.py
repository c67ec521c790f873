"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8, first 3 dense,
MTP auxiliary head.  [arXiv:2412.19437; hf]
61L d_model=7168 128H d_ff=2048(expert) vocab=129280."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280, head_dim=128,
    moe=True, n_experts=256, top_k=8, n_shared_experts=1,
    moe_d_ff=2048, first_k_dense=3, dense_d_ff=18432,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    mtp=True,
)
