"""musicgen-large — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]
48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.  Modality frontend is a
stub: input_specs() provides precomputed frame embeddings (input_mode
= embeddings); the EnCodec tokenizer/codebook interleaving stays upstream."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, head_dim=64, input_mode="embeddings",
)
