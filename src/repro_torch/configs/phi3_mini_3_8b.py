"""phi3-mini-3.8b [dense] — RoPE SwiGLU, kv=32 => MHA (arXiv:2404.14219).

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
Full-attention: long_500k skipped (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3_mini_3_8b", family="dense",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        head_dim=96, d_ff=8192, vocab_size=32064,
        block_pattern=("attn",), tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, dtype="float32")
