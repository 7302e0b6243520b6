"""Moonlight-16B-A3B (moonshot) — MoE 64 experts top-6, GQA kv=16.
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", num_layers=48, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1408,
    vocab_size=163840, num_experts=64, top_k=6, rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
)

REDUCED = ModelConfig(
    name="moonshot-reduced", family="moe", num_layers=2, d_model=256,
    num_heads=4, num_kv_heads=4, head_dim=64, d_ff=128, vocab_size=512,
    num_experts=4, top_k=2, source="hf:moonshotai/Moonlight-16B-A3B",
    capacity_factor=8.0,
)
