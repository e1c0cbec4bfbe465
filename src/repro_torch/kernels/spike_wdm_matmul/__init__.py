from .ops import spike_wdm_matmul, spike_wdm_matmul_ref
