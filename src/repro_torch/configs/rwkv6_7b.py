"""rwkv6-7b [ssm]: 32L d=4096 attention-free (Finch: data-dependent decay)
d_ff=14336 vocab=65536; head_dim 64 => 64 WKV heads  [arXiv:2404.05892]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm", num_layers=32, d_model=4096,
    num_heads=64, num_kv_heads=64, d_ff=14336, vocab_size=65536,
    rwkv_head_dim=64, ffn_type="rwkv",
)
