"""Mixtral-8x7B — MoE 8 experts top-2, GQA kv=8, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
    num_experts=8, top_k=2, attn_window=4096, rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)

REDUCED = ModelConfig(
    name="mixtral-reduced", family="moe", num_layers=2, d_model=256,
    num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
    num_experts=4, top_k=2, attn_window=64, source="arXiv:2401.04088",
    capacity_factor=8.0,
)
