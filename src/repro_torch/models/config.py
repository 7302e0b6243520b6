"""Model configuration dataclasses (port of ``repro/models/config.py``).

A copy, so the port imports nothing of ``repro``. ``ShardCtx`` is not
ported: the port runs on one card, so it calls the padding helpers with
tp=1 (the vocab still pads to a multiple of 128, as in the reference, so
logits keep the reference's ``(B, V_pad)`` shape).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- attention flavour
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_window: int = 0           # 0 = full attention; >0 = sliding window
    # --- MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0            # hybrid: shared attn block every k layers
    # --- encoder/decoder
    encoder_layers: int = 0
    # --- modality frontend stub: "text" | "vision" | "audio"
    modality: str = "text"
    mlp_type: str = "swiglu"       # swiglu | gelu
    dtype: str = "bfloat16"
    # --- source citation (paper / model card this config reproduces)
    source: str = ""
    # --- training
    max_grad_norm: float = 1.0
    lr: float = 3e-4

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def padded_vocab(self, tp: int) -> int:
        mult = 128 * max(tp, 1)
        return math.ceil(self.vocab_size / mult) * mult

    def padded_ff(self, tp: int) -> int:
        mult = max(tp, 1)
        return math.ceil(self.d_ff / mult) * mult

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_ssm_family(self) -> bool:
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"
    microbatch: int = 0            # 0 -> auto


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in
                (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
