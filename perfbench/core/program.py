"""The program under test, as the benchmark sees it: its configuration for
a configuration file, and the one scheduling rule the warm-up mirrors."""

from __future__ import annotations


def arch_config(config: dict):
    """The program's ``ArchConfig`` run as ``config`` states it: the
    program's entry for the architecture, with every published size, the
    RMSNorm epsilon, the matmul mode and the KV dtype set from the file.
    Raises where the program's block is not the published one."""
    from repro_torch.configs.base import get_arch
    model, prog = config["model"], config["program"]
    H = model["num_attention_heads"]
    arch = get_arch(prog["arch"]).replace(
        num_layers=model["num_hidden_layers"], d_model=model["hidden_size"],
        num_heads=H, num_kv_heads=model["num_key_value_heads"],
        head_dim=model.get("head_dim", model["hidden_size"] // H),
        d_ff=model["intermediate_size"], vocab_size=model["vocab_size"],
        rope_theta=float(model["rope_theta"]),
        tie_embeddings=bool(model["tie_word_embeddings"]),
        norm_eps=float(model["rms_norm_eps"]), qkv_bias=True,
        matmul_mode=prog["matmul_mode"],
        kv_cache_int8=prog["kv_dtype"] == "int8")
    if (arch.family != "dense" or arch.ffn_type != "swiglu"
            or model["hidden_act"] != "silu"):
        raise ValueError(f"{config['name']}: the program's block is not "
                         f"the published Qwen2 block")
    return arch


def prefill_bucket(prompt_len: int, cache_T: int) -> int:
    """The padded length the scheduler gives a prompt."""
    from repro_torch.serving.scheduler import prefill_bucket_len
    return prefill_bucket_len(prompt_len, cache_T)
