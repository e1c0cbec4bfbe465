"""Config module for --arch qwen1.5-4b (see registry.py for the exact parameters)."""
from .registry import get_config, smoke_config as _smoke

CONFIG = get_config("qwen1.5-4b")
SMOKE = _smoke("qwen1.5-4b")
