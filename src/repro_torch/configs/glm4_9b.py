"""GLM-4-9B — dense decoder, GQA kv=2, RoPE. [hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=151552,
    rope_theta=10_000.0, source="hf:THUDM/glm-4-9b",
)

REDUCED = ModelConfig(
    name="glm4-9b-reduced", family="dense", num_layers=2, d_model=256,
    num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
    rope_theta=10_000.0, source="hf:THUDM/glm-4-9b",
)
