"""Phi-3-vision 4.2B — VLM: phi3-mini decoder + CLIP frontend (stubbed).
[hf:microsoft/Phi-3-vision-128k-instruct]

The vision tower is a stub: the batch supplies precomputed patch
embeddings occupying the first seq_len//8 positions."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064,
    modality="vision", rope_theta=10_000.0,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

REDUCED = ModelConfig(
    name="phi-3-vision-reduced", family="vlm", num_layers=2, d_model=256,
    num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512,
    modality="vision", source="hf:microsoft/Phi-3-vision-128k-instruct",
)
