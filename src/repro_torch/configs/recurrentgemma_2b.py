"""RecurrentGemma-2B — RG-LRU + local attention hybrid, 2 recurrent blocks
per 1 local-attention block. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig, ATTN, RGLRU

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,              # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attn_pattern=(RGLRU, RGLRU, ATTN),
    window=2048,               # local attention window -> sub-quadratic
    lru_width=2560,
    source="arXiv:2402.19427",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="recurrentgemma-reduced", n_layers=3, d_model=256, n_heads=4,
        n_kv_heads=1, head_dim=64, d_ff=512, vocab_size=256, window=64,
        lru_width=256, lora_rank=4, dtype="float32", seq_shard=False,
        scan_chunk=32)
