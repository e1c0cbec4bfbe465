"""Config module for --arch phi3-medium-14b (see registry.py for the exact parameters)."""
from .registry import get_config, smoke_config as _smoke

CONFIG = get_config("phi3-medium-14b")
SMOKE = _smoke("phi3-medium-14b")
