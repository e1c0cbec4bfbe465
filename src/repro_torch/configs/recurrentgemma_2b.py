"""Config module for --arch recurrentgemma-2b (see registry.py for the exact parameters)."""
from .registry import get_config, smoke_config as _smoke

CONFIG = get_config("recurrentgemma-2b")
SMOKE = _smoke("recurrentgemma-2b")
