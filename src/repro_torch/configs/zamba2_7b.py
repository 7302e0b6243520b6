"""Zamba2-7B — hybrid: Mamba2 backbone + shared attention block every 6
layers (weights shared across invocations). [arXiv:2411.15242]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
    num_heads=32, num_kv_heads=32, d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    attn_every=6, source="arXiv:2411.15242",
)

REDUCED = ModelConfig(
    name="zamba2-reduced", family="hybrid", num_layers=3, d_model=256,
    num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_groups=1,
    attn_every=2, source="arXiv:2411.15242",
)
