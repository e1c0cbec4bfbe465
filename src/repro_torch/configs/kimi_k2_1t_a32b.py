"""Config module for --arch kimi-k2-1t-a32b (see registry.py for the exact parameters)."""
from .registry import get_config, smoke_config as _smoke

CONFIG = get_config("kimi-k2-1t-a32b")
SMOKE = _smoke("kimi-k2-1t-a32b")
