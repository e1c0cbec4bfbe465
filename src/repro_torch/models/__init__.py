"""The port of ``repro.models``: config, parameter init, block forwards and
the prefill/decode driver (mamba2 blocks only so far)."""
