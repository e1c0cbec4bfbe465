"""The port of ``repro.optim``: AdamW on trees of tensors.  The int8
gradient compression (``optim/compression.py``, two cross-pod
collectives) waits for multi-card placement (ROADMAP.md §1 item 2)."""
from .adamw import AdamWConfig, AdamWState, apply_updates, global_norm, init_state, schedule
