"""CLIP ViT-B/32-style dual encoder — the paper's own foundation model.
Used by the FL examples/benchmarks (at reduced scale on CPU).
[arXiv:2103.00020 via paper ref [1]]"""
from repro_torch.configs.base import ModelConfig

# The dual-encoder is built in repro.core.clip; this ModelConfig describes
# the *text/vision transformer trunk* shape used when CLIP participates in
# the generic model registry (e.g. dry-run of the paper's own backbone).
CONFIG = ModelConfig(
    name="clip-b32",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=49408,
    mlp="gelu",
    source="arXiv:2103.00020",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="clip-b32-reduced", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=256,
        lora_rank=4, dtype="float32", seq_shard=False)
