from .registry import ARCH_NAMES, get_config, register, smoke_config

__all__ = ["ARCH_NAMES", "get_config", "register", "smoke_config"]
