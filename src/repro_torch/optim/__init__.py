"""The port of ``repro.optim``: AdamW on trees of tensors, and the int8
gradient compression with its two collectives over ``torch.distributed``
(``compression.py``), which ``launch.steps.make_train_step_compressed``
runs across pods."""
from .adamw import AdamWConfig, AdamWState, apply_updates, global_norm, init_state, schedule
from .compression import (
    CompressedGrad, compress_tree, decompress_tree, dequantize, psum_compressed,
    quantize, ring_psum_int8,
)
