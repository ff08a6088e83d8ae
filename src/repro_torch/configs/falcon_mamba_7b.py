"""Falcon-Mamba-7B — attention-free Mamba-1 SSM. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig, SSM

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                    # mamba block subsumes the FFN
    vocab_size=65024,
    attn_pattern=(SSM,),
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    source="arXiv:2410.05355",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="falcon-mamba-reduced", n_layers=2, d_model=256,
        vocab_size=256, ssm_state=8, lora_rank=4, dtype="float32",
        seq_shard=False, scan_chunk=32)
