"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, early
fusion (hf:meta-llama/Llama-4-Scout-17B-16E; unverified).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4_scout_17b_a16e", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=202048,
        block_pattern=("moe",), rope_theta=500000.0,
        num_experts=16, top_k=1, router_type="sigmoid",
        moe_shared_expert=True, tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, num_experts=4, capacity_factor=8.0,
        dtype="float32")
