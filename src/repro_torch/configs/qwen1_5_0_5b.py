"""qwen1.5-0.5b [dense] — QKV bias (hf:Qwen/Qwen1.5-0.5B; hf).

24L d_model=1024 16H (MHA kv=16) d_ff=2816 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1_5_0_5b", family="dense",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=2816, vocab_size=151936,
        block_pattern=("attn",), qkv_bias=True, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=176, vocab_size=512, dtype="float32")
