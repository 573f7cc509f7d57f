"""seamless-m4t-medium [audio]: encoder-decoder, 12 encoder + 12 decoder
layers, d=1024 16H (kv=16) d_ff=4096 vocab=256206.  The speech/text
modality frontend is a stub: requests carry precomputed frame embeddings
(``src_embeds``) for the encoder  [arXiv:2308.11596]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio", num_layers=12, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=256206,
    head_dim=64, ffn_type="gelu", rope_theta=1e4, encoder_layers=12,
)
