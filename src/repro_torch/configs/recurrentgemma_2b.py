"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern
(arXiv:2402.19427; hf).

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, lru width 2560,
local window 2048.  Pattern (rec, rec, lattn) cycled.  Sub-quadratic:
runs long_500k (constant-size recurrent state + bounded window cache).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_2b", family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        block_pattern=("rec", "rec", "lattn"), mlp_type="geglu",
        local_window=2048, rnn_width=2560, conv_width=4,
        embed_scale_sqrt_dim=True, tie_embeddings=True,
        scan_layers=False, supports_long_context=True, seq_shard=False)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=3, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=192, vocab_size=512, rnn_width=64, local_window=16,
        dtype="float32")
