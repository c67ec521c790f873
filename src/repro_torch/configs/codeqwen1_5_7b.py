"""codeqwen1.5-7b — qwen1.5-arch (MHA).  [hf:Qwen/CodeQwen1.5-7B; hf]
32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, head_dim=128,
)
