"""Whisper-medium — encoder-decoder audio transformer backbone.
Conv/mel frontend is a stub: input_specs provides precomputed frame
embeddings (B, 1500, d_model). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,               # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,             # MHA
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    n_frames=1500,
    use_rope=False,            # whisper uses absolute positions
    max_pos=32_768,            # decode_32k context (long_500k skipped: full attn)
    mlp="gelu",
    source="arXiv:2212.04356",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-reduced", n_layers=2, encoder_layers=2, d_model=256,
        n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512, vocab_size=256,
        n_frames=32, max_pos=512, lora_rank=4, dtype="float32",
        seq_shard=False)
