"""Kimi-K2 — trillion-param MoE, 384 experts top-8 (+1 shared), first layer
dense (paper-table). [arXiv:2501.kimi2]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,                 # per-expert FFN width
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
    n_shared_experts=1,
    first_k_dense=1,
    dense_d_ff=18432,
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="kimi-k2-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=128, vocab_size=256, n_experts=4,
        experts_per_token=2, n_shared_experts=1, first_k_dense=1,
        dense_d_ff=512, lora_rank=4, dtype="float32", seq_shard=False)
