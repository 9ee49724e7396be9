"""mistral-nemo-12b [dense] — 128k ctx (hf:mistralai/Mistral-Nemo-Base-2407).

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128
(explicit: 32*128=4096 != d_model).  rope theta 1e6 for long context.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral_nemo_12b", family="dense",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=131072,
        block_pattern=("attn",), rope_theta=1e6, tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=512, dtype="float32")
