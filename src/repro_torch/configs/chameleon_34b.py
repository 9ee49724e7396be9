"""chameleon-34b [vlm] — early-fusion, VQ image tokens (arXiv:2405.09818;
unverified).  48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.

VQ image tokens share the text vocabulary (early fusion), so the backbone is
a plain decoder; the VQ tokenizer frontend is a stub (tokens arrive
pre-quantized).  Chameleon uses qk-norm for training stability.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon_34b", family="vlm",
        num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=22016, vocab_size=65536,
        block_pattern=("attn",), qk_norm=True, tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=512, dtype="float32")
