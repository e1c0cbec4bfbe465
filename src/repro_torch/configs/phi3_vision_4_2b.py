"""Config module for --arch phi-3-vision-4.2b (see registry.py for the exact parameters)."""
from .registry import get_config, smoke_config as _smoke

CONFIG = get_config("phi-3-vision-4.2b")
SMOKE = _smoke("phi-3-vision-4.2b")
