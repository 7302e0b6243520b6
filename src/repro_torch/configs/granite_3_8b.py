"""Granite-3 8B — dense decoder, GQA kv=8. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=12800, vocab_size=49155,
    rope_theta=10_000.0, source="hf:ibm-granite/granite-3.0-2b-base",
)

REDUCED = ModelConfig(
    name="granite-3-8b-reduced", family="dense", num_layers=2, d_model=256,
    num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
