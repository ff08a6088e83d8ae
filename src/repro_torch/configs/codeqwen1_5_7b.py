"""CodeQwen1.5-7B — qwen1.5-arch dense decoder (MHA). [hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,             # MHA per assignment (GQA kv=32)
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    rope_theta=1_000_000.0,
    source="hf:Qwen/CodeQwen1.5-7B",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="codeqwen-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, head_dim=64, d_ff=512, vocab_size=256,
        lora_rank=4, dtype="float32", seq_shard=False)
