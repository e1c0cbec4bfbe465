"""Config module for --arch llama3.2-3b (see registry.py for the exact parameters)."""
from .registry import get_config, smoke_config as _smoke

CONFIG = get_config("llama3.2-3b")
SMOKE = _smoke("llama3.2-3b")
