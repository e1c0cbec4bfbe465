"""Config module for --arch musicgen-large (see registry.py for the exact parameters)."""
from .registry import get_config, smoke_config as _smoke

CONFIG = get_config("musicgen-large")
SMOKE = _smoke("musicgen-large")
