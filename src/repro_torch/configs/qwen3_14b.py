"""Qwen3-14B — dense decoder, GQA kv=8, qk-norm. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=17408,
    vocab_size=151936, qk_norm=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)

REDUCED = ModelConfig(
    name="qwen3-14b-reduced", family="dense", num_layers=2, d_model=256,
    num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
    qk_norm=True, rope_theta=1_000_000.0, source="hf:Qwen/Qwen3-8B",
)
