from repro_torch.configs.base import ArchConfig, get_arch, pad_vocab

__all__ = ["ArchConfig", "get_arch", "pad_vocab"]
