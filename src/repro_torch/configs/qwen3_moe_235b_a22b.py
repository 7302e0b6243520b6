"""Qwen3-235B-A22B — MoE, 128 experts top-8, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B scaled per assignment]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", num_layers=94, d_model=4096,
    num_heads=64, num_kv_heads=4, head_dim=128, d_ff=1536,
    vocab_size=151936, num_experts=128, top_k=8, qk_norm=True,
    rope_theta=1_000_000.0, source="hf:Qwen/Qwen3-30B-A3B",
)

REDUCED = ModelConfig(
    name="qwen3-moe-reduced", family="moe", num_layers=2, d_model=256,
    num_heads=4, num_kv_heads=2, head_dim=64, d_ff=128, vocab_size=512,
    num_experts=4, top_k=2, qk_norm=True, source="hf:Qwen/Qwen3-30B-A3B",
    capacity_factor=8.0,
)
