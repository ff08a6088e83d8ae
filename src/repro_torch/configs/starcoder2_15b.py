"""StarCoder2-15B — dense decoder, GQA + RoPE, GELU MLP. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp="gelu",
    rope_theta=100_000.0,
    source="arXiv:2402.19173",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="starcoder2-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=256,
        lora_rank=4, dtype="float32", seq_shard=False)
