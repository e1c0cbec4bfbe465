"""The port of ``repro.models``: config, parameter init, block forwards and
prefill/decode (attention, RG-LRU and Mamba-2 blocks; dense and MoE
feed-forwards)."""
