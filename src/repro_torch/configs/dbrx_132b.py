"""dbrx-132b [moe] — 16 experts top-4, fine-grained
(hf:databricks/dbrx-base; unverified).

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx_132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=10752, vocab_size=100352,
        block_pattern=("moe",), norm_type="layernorm",
        rope_theta=500000.0, num_experts=16, top_k=4,
        tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512, num_experts=4, top_k=2,
        capacity_factor=8.0, dtype="float32")
