"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) per-expert
d_ff=512, MoE 32 experts top-8  [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=512, vocab_size=49155,
    head_dim=64, ffn_type="swiglu", rope_theta=1e4,
    num_experts=32, top_k=8,
)
