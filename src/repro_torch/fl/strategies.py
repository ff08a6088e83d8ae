"""The three experimental arms of the paper, port of
``repro.fl.strategies``.

- fedclip      : frozen CLIP + attention adapter, fp32 communication.
- qlora_nogan  : + NF4-quantized backbone + LoRA, quantized (int8) comm.
- tripleplay   : qlora_nogan + client-side GAN long-tail rebalancing.
"""
from __future__ import annotations

from dataclasses import dataclass

# Blockwise update-quantization layout of the compressed uplink
COMM_BLOCK = 64
COMM_MIN_SIZE = 256
COMM_SKIP = ("slot",)

# Per-client local-step multiplier cap (availability traces)
MAX_STEP_MULT = 4

# GAN rebalancing thresholds
GAN_MIN_POOL = 8          # clients with n < this skip GAN rebalancing
GAN_BATCH_MAX = 64        # GAN minibatch cap
GAN_RNG_OFFSET = 100      # client i's GAN stream is seeded from OFFSET + i


def gan_batch_size(n: int) -> int:
    """The GAN minibatch of a client with ``n`` local samples:
    ``min(GAN_BATCH_MAX, n)``. The fleet engine groups clients by it (a
    batch-mean loss cannot be padded without its mask correction)."""
    return min(GAN_BATCH_MAX, int(n))


@dataclass(frozen=True)
class Strategy:
    name: str
    use_lora: bool
    backbone_bits: int       # 0 = bf16/f32 backbone
    backbone_mode: str
    comm_bits: int           # 0 = fp32 updates
    use_gan: bool

    def comm_quantize(self, delta):
        """Quantize an update tree per this arm's uplink compression."""
        if not self.comm_bits:
            return delta
        from repro_torch.core.quant import quantize_tree
        return quantize_tree(delta, bits=self.comm_bits, block=COMM_BLOCK,
                             min_size=COMM_MIN_SIZE, skip_names=COMM_SKIP)


STRATEGIES = {
    "fedclip": Strategy("fedclip", use_lora=False, backbone_bits=0,
                        backbone_mode="linear", comm_bits=0, use_gan=False),
    "qlora_nogan": Strategy("qlora_nogan", use_lora=True, backbone_bits=4,
                            backbone_mode="nf4", comm_bits=8,
                            use_gan=False),
    "tripleplay": Strategy("tripleplay", use_lora=True, backbone_bits=4,
                           backbone_mode="nf4", comm_bits=8, use_gan=True),
}
