"""Architecture configuration (port of ``repro/configs/base.py``).

Only the dense causal-LM family is ported so far.  ``get_arch`` raises
``NotImplementedError`` for every architecture whose family has no port
yet, instead of handing back a config the models cannot run.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.core.bp_matmul import MODES as MATMUL_MODES
from repro_torch.kernels.bitparticle_matmul.ops import \
    BACKENDS as MATMUL_BACKENDS

VOCAB_PAD_MULTIPLE = 256  # divisible by every mesh (data x model) product

ARCH_IDS = (
    "phi3-medium-14b", "granite-34b", "qwen2-1.5b", "qwen2-7b", "qwen2-vl-7b",
    "rwkv6-7b", "zamba2-2.7b", "moonshot-v1-16b-a3b", "granite-moe-1b-a400m",
    "seamless-m4t-medium",
)

#: architectures whose config module has been ported
PORTED_ARCHS = ("qwen2-1.5b",)


def pad_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense (only family ported)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    ffn_type: str = "swiglu"          # swiglu | gelu
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # numerics: bf16 | bp_exact | bp_approx
    matmul_mode: str = "bf16"
    # quantized-matmul backend (see kernels/bitparticle_matmul/ops.py)
    matmul_backend: str = "auto"
    # int8 KV cache with per-token-per-head scales
    kv_cache_int8: bool = False

    def __post_init__(self):
        if self.matmul_mode not in MATMUL_MODES:
            raise NotImplementedError(
                f"matmul_mode {self.matmul_mode!r} is not ported; expected "
                f"one of {MATMUL_MODES}")
        if self.matmul_backend not in MATMUL_BACKENDS:
            raise ValueError(
                f"unknown matmul_backend {self.matmul_backend!r}; expected "
                f"one of {MATMUL_BACKENDS}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.num_heads, 1)

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab_size)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return self.replace(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads,
                                    4 * self.num_kv_heads
                                    // max(self.num_heads, 1), 4)),
            d_ff=256,
            vocab_size=512,
            head_dim=32,
        )


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}")
    if name not in PORTED_ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ported: "
            f"{PORTED_ARCHS})")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
