"""Model / run configuration dataclasses, port of ``repro.configs.base``
(a copy: the port imports nothing of the JAX package).

Every assigned architecture gets one module in this package defining
``CONFIG`` with the exact published shape, plus ``reduced()`` returning the
smoke-test variant (≤2 layers, d_model ≤ 512, ≤4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds used in per-layer patterns.
ATTN = "attn"
RGLRU = "rglru"
SSM = "ssm"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""  # citation per assignment

    # attention
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window size (None = full)
    attn_pattern: Tuple[str, ...] = (ATTN,)  # repeating per-layer pattern
    use_rope: bool = True                 # False -> learned absolute pos emb
    max_pos: int = 0                      # needed when use_rope=False
    mlp: str = "swiglu"                   # swiglu | gelu

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0                   # d_ff of the first_k_dense layers
    capacity_factor: float = 1.25
    moe_dispatch_bits: int = 0            # 0 | 8: int8 all-to-all payloads
                                          # (DeepSeek-V3-style low-precision
                                          # dispatch — beyond-paper §Perf)

    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0                  # 0 -> ceil(d_model/16)

    # hybrid (RG-LRU)
    lru_width: int = 0

    # enc-dec / modality frontend stubs
    encoder_layers: int = 0
    n_frames: int = 0                     # audio: precomputed frame embeds
    n_patches: int = 0                    # vlm: precomputed patch embeds

    # TriplePlay technique knobs
    lora_rank: int = 16
    lora_alpha: float = 32.0
    quant_bits: int = 0                   # 0 = bf16 backbone, 8, or 4
    quant_block: int = 128
    quant_mode: str = "linear"            # linear | nf4
    kv_quant_bits: int = 0                # 0 | 8: int8 KV/ring cache
    grad_accum: int = 1                   # microbatches per train step
    trainable_dtype: str = "float32"      # LoRA/adapter params (bfloat16
                                          # halves their collective bytes;
                                          # Adam moments stay f32)
    adapter_heads: int = 8
    adapter_d_ff: int = 0                 # 0 -> d_model
    adapter_window: int = 4096            # adapter attention window at serve
                                          # time (keeps SSM/SWA archs sub-
                                          # quadratic; train is full causal)

    # numerics / memory
    dtype: str = "bfloat16"
    remat: bool = True
    seq_shard: bool = True                # sequence-parallel residual stream
    scan_chunk: int = 256                 # SSM/LRU chunked-scan chunk length
    # dry-run cost calibration (see launch/dryrun.py): unroll the layer
    # stack and remove inner loops so XLA cost_analysis counts every FLOP
    # (loop bodies are otherwise counted once regardless of trip count)
    unroll_layers: bool = False
    calibrate: bool = False

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string, expanding the repeating pattern."""
        pat = self.attn_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for 6·N·D model-flops) -------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate backbone parameter count (embeddings included)."""
        d, V = self.d_model, self.vocab_size
        n = 2 * V * d  # embed + head (untied)
        if self.encoder_layers:
            n += self.max_pos * d + self.n_frames * 0
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.mlp == "swiglu":
            per_mlp = lambda ff: 3 * d * ff
        else:
            per_mlp = lambda ff: 2 * d * ff
        kinds = self.layer_kinds()
        for i, k in enumerate(kinds):
            if k == ATTN or self.family in ("dense", "moe", "vlm", "encdec"):
                if k == ATTN:
                    n += per_attn
            if k == SSM:
                di, N, R = self.d_inner, self.ssm_state, self.dt_rank
                n += d * 2 * di + di * self.ssm_conv + di * (R + 2 * N)
                n += R * di + di * N + 2 * di + di * d
                continue
            if k == RGLRU:
                w = self.lru_width or d
                n += 2 * d * w + w * d + 3 * w + 2 * w * (self.ssm_conv or 4)
                continue
            # feed-forward part of an attention layer
            if self.n_experts and i >= self.first_k_dense:
                e = self.experts_per_token if active_only else self.n_experts
                n += (e + self.n_shared_experts) * per_mlp(self.d_ff)
                n += d * self.n_experts  # router
            else:
                n += per_mlp(self.dense_d_ff or self.d_ff)
        if self.encoder_layers:  # add encoder stack (attention + mlp, no kv cache)
            n += self.encoder_layers * (per_attn + per_mlp(self.d_ff) + 2 * d * self.head_dim * 0)
            # cross-attention in every decoder layer
            n += self.n_layers * per_attn
        return int(n)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
