"""Config module for --arch olmoe-1b-7b (see registry.py for the exact parameters)."""
from .registry import get_config, smoke_config as _smoke

CONFIG = get_config("olmoe-1b-7b")
SMOKE = _smoke("olmoe-1b-7b")
