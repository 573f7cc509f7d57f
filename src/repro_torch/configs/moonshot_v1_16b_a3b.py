"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (kv=16) per-expert d_ff=1408,
MoE 64 experts top-6 (Moonlight)  [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe", num_layers=48, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=163840,
    head_dim=128, ffn_type="swiglu", rope_theta=1e6,
    num_experts=64, top_k=6,
)
