"""Qwen3-MoE 235B-A22B-style — 128 experts, top-8, GQA. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,                 # per-expert FFN width
    vocab_size=151936,
    n_experts=128,
    experts_per_token=8,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen3-moe-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=128, vocab_size=256,
        n_experts=4, experts_per_token=2, lora_rank=4, dtype="float32",
        seq_shard=False)
