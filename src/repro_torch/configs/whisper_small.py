"""whisper-small [audio] — enc-dec, conv frontend STUB (arXiv:2212.04356).

12L (encoder) + 12L (decoder), d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865.  The mel/conv frontend is stubbed: input_specs() provides
precomputed frame embeddings (B, 1500, 768) per the brief.  Encoder-decoder
(not encoder-only) so decode shapes run.  Full attention: long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper_small", family="audio",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=3072, vocab_size=51865,
        block_pattern=("attn",), mlp_type="gelu", norm_type="layernorm",
        rope_theta=None, encoder_layers=12, encoder_seq=1500,
        tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        encoder_seq=32, dtype="float32")
