"""granite-34b [dense]: 88L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152
llama-arch code model; MQA + GELU MLP (d_ff = 4*d)  [arXiv:2405.04324]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense", num_layers=88, d_model=6144,
    num_heads=48, num_kv_heads=1, d_ff=24576, vocab_size=49152,
    head_dim=128, ffn_type="gelu", rope_theta=1e5,
)
