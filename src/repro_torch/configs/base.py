"""Architecture configuration (port of ``repro/configs/base.py``).

Every architecture of ``ARCH_IDS`` is ported: the dense causal-LM family
(``qwen2-1.5b``, ``qwen2-7b``, ``phi3-medium-14b``, ``granite-34b``), the
mixture-of-experts family (``family="moe"``: ``granite-moe-1b-a400m``,
``moonshot-v1-16b-a3b``), the vision-language family (``family="vlm"``:
``qwen2-vl-7b``, M-RoPE over precomputed patch embeddings), the RWKV-6
family (``family="ssm"``: ``rwkv6-7b``), the Mamba-2 hybrid
(``family="hybrid"``: ``zamba2-2.7b``) and the encoder-decoder
(``family="audio"``: ``seamless-m4t-medium``, over precomputed frame
embeddings).

Every workload shape is a ``ShapeConfig``; ``runnable_cells()`` yields the
(arch x shape) grid with the reference's applicability rule (``long_500k``
only for the sub-quadratic families), which the dry run
(``launch/dryrun.py``) walks.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

from repro_torch.core.bp_matmul import MODES as MATMUL_MODES, base_mode
from repro_torch.kernels.bitparticle_matmul.ops import \
    BACKENDS as MATMUL_BACKENDS

VOCAB_PAD_MULTIPLE = 256  # divisible by every mesh (data x model) product

ARCH_IDS = (
    "phi3-medium-14b", "granite-34b", "qwen2-1.5b", "qwen2-7b", "qwen2-vl-7b",
    "rwkv6-7b", "zamba2-2.7b", "moonshot-v1-16b-a3b", "granite-moe-1b-a400m",
    "seamless-m4t-medium",
)

#: architectures whose config module has been ported
PORTED_ARCHS = ("qwen2-1.5b", "qwen2-7b", "phi3-medium-14b", "granite-34b",
                "granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "rwkv6-7b",
                "qwen2-vl-7b", "zamba2-2.7b", "seamless-m4t-medium")


def pad_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    ffn_type: str = "swiglu"          # swiglu | gelu | rwkv
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    attn_every: int = 0               # zamba2: shared attn applied every N layers
    # RWKV
    rwkv_head_dim: int = 64
    # encoder-decoder
    encoder_layers: int = 0
    # VLM (M-RoPE)
    mrope_sections: Tuple[int, ...] = ()
    # numerics: bf16 | qat | bp_exact | bp_approx (each may carry the
    # '+q8gather' suffix: int8 weight gathers, see core/bp_matmul.py)
    matmul_mode: str = "bf16"
    # quantized-matmul backend (see kernels/bitparticle_matmul/ops.py)
    matmul_backend: str = "auto"
    # int8 KV cache with per-token-per-head scales
    kv_cache_int8: bool = False

    def __post_init__(self):
        if base_mode(self.matmul_mode) not in MATMUL_MODES:
            raise NotImplementedError(
                f"matmul_mode {self.matmul_mode!r} is not ported; expected "
                f"one of {MATMUL_MODES}, optionally with '+q8gather'")
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

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            num_layers=min(self.num_layers,
                           4 if not self.attn_every else 2 * self.attn_every),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads,
                                    4 * self.num_kv_heads
                                    // max(self.num_heads, 1), 4)),
            d_ff=256,
            vocab_size=512,
            head_dim=32,
        )
        if self.num_experts:
            kw.update(num_experts=min(self.num_experts, 8),
                      top_k=min(self.top_k, 2), d_ff=64)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32)
        if self.family == "ssm":
            kw.update(rwkv_head_dim=32, num_heads=4)
        if self.encoder_layers:
            kw.update(encoder_layers=2)
        if self.mrope_sections:
            kw.update(mrope_sections=(4, 6, 6))  # sums to head_dim/2 = 16
        return self.replace(**kw)

    def param_count(self, *, active_only: bool = False) -> int:
        """The reference's parameter-count estimate (for 6*N*D model
        FLOPs): the LM head counts once, the embedding lookup not; MoE
        counts ``top_k`` experts with ``active_only``."""
        d, l = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        attn = (d * hd * (self.num_heads + 2 * self.num_kv_heads)
                + self.num_heads * hd * d)
        ffn_dense = (3 if self.ffn_type == "swiglu" else 2) * d * self.d_ff
        if self.num_experts:
            n_exp = self.top_k if active_only else self.num_experts
            ffn = n_exp * ffn_dense + d * self.num_experts  # + router
        else:
            ffn = ffn_dense
        if self.family == "ssm":                      # rwkv6 block
            blk = 5 * d * d + 2 * d * self.d_ff       # time-mix + channel-mix
        elif self.family == "hybrid":     # mamba2 + shared attn amortized
            d_in = 2 * d
            blk = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            n_attn = l // max(self.attn_every, 1)
            blk += (attn + ffn) * n_attn / max(l, 1)
        else:
            blk = attn + ffn
        total = l * blk + self.vocab_padded * d
        if self.encoder_layers:
            total += self.encoder_layers * (attn + ffn)   # encoder stack
            total += l * (d * hd * (self.num_heads + 2 * self.num_kv_heads)
                          + self.num_heads * hd * d)      # cross-attention
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


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


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """``long_500k`` needs sub-quadratic attention: SSM / hybrid only."""
    if shape.name == "long_500k":
        return arch.sub_quadratic
    return True


def runnable_cells():
    """All (arch_id, shape_name) cells per the applicability rule."""
    for aid in ARCH_IDS:
        arch = get_arch(aid)
        for sname, shape in SHAPES.items():
            if shape_applicable(arch, shape):
                yield aid, sname
