"""Config module for --arch mamba2-130m (see registry.py for the exact parameters)."""
from .registry import get_config, smoke_config as _smoke

CONFIG = get_config("mamba2-130m")
SMOKE = _smoke("mamba2-130m")
