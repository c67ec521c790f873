"""llava-next-mistral-7b — mistral backbone, anyres vision stub.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.  The anyres tiling
vision tower is a stub: input_specs() provides patch embeddings already
projected to d_model, concatenated with text embeddings upstream."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128, input_mode="embeddings",
)
