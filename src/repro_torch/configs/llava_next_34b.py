"""LLaVA-NeXT-34B — VLM; Yi-34B-style decoder backbone; vision tower +
projector are a stub (input_specs provides patch embeddings; anyres tiling
represented by the base 576-patch grid). [hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    n_patches=576,
    rope_theta=5_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="llava-next-reduced", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=256, n_patches=16,
        lora_rank=4, dtype="float32", seq_shard=False)
