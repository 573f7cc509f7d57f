"""qwen2-7b [dense]: 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
GQA with QKV bias  [arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    head_dim=128, qkv_bias=True, ffn_type="swiglu", rope_theta=1e6,
)
