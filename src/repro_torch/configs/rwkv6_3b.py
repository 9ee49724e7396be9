"""rwkv6-3b [ssm] — Finch, data-dependent decay (arXiv:2404.05892; hf).

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.  head size 64 =>
40 WKV heads.  Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6_3b", family="ssm",
        num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=64, d_ff=8960, vocab_size=65536,
        block_pattern=("rwkv",), norm_type="layernorm",
        rope_theta=None, tie_embeddings=False,
        wkv_impl="chunked", supports_long_context=True, seq_shard=False)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
        d_ff=448, vocab_size=512, dtype="float32")
