"""qwen2-vl-7b [vlm]: qwen2-7b backbone + M-RoPE (3D rotary, sections
16/24/24 over head_dim/2) and dynamic-resolution patch embeddings.  The
vision frontend is a stub: requests carry precomputed patch embeddings
(``vision_embeds``) spliced into the token stream at ``vision_mask``
[arXiv:2409.12191]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    head_dim=128, qkv_bias=True, ffn_type="swiglu", rope_theta=1e6,
    mrope_sections=(16, 24, 24),
)
