"""H2O-Danube3-4B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    window=4096,               # mistral-style SWA -> sub-quadratic decode
    rope_theta=10_000.0,
    source="arXiv:2401.16818",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="h2o-danube-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=256, window=64,
        lora_rank=4, dtype="float32", seq_shard=False)
