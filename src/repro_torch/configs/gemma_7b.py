"""gemma-7b [dense] — GeGLU, head_dim=256 (arXiv:2403.08295; hf).

28L d_model=3072 16H (MHA kv=16) d_ff=24576 vocab=256000.  Embeddings scaled
by sqrt(d_model); tied unembedding; RMSNorm with (1+scale).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma_7b", family="dense",
        num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
        head_dim=256, d_ff=24576, vocab_size=256000,
        block_pattern=("attn",), mlp_type="geglu",
        embed_scale_sqrt_dim=True, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=256, vocab_size=512, dtype="float32")
