"""Config module for --arch qwen3-8b (see registry.py for the exact parameters)."""
from .registry import get_config, smoke_config as _smoke

CONFIG = get_config("qwen3-8b")
SMOKE = _smoke("qwen3-8b")
