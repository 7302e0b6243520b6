"""SeamlessM4T-medium — encoder-decoder speech/text backbone.
[arXiv:2308.11596]

Audio frontend (mel + conformer conv) is stubbed: the batch supplies
precomputed frame embeddings (B, S, d). 12 encoder + 12 decoder layers,
classic (non-gated) GELU FFN."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=12,
    encoder_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, modality="audio", mlp_type="gelu",
    source="arXiv:2308.11596",
)

REDUCED = ModelConfig(
    name="seamless-reduced", family="encdec", num_layers=2,
    encoder_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
    vocab_size=512, modality="audio", mlp_type="gelu",
    source="arXiv:2308.11596",
)
