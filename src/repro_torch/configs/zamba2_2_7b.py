"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d=2560, ssm_state=64, plus a
SHARED attention+MLP block (32H, kv=32, d_ff=10240) applied every 6 layers
with per-invocation input norms [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
    head_dim=80, ssm_state=64, ssm_head_dim=64, attn_every=6,
    ffn_type="gelu", rope_theta=1e4,
)
