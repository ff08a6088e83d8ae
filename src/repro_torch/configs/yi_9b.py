"""Yi-9B — llama-arch dense decoder with GQA. [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=10_000.0,
    source="arXiv:2403.04652",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="yi-9b-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=256,
        lora_rank=4, dtype="float32", seq_shard=False)
