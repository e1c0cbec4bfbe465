"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
no sparsity, at the full 700 W power limit)."""

HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
BF16_FLOPS_S = 989e12
TF32_FLOPS_S = 495e12
F32_FLOPS_S = 67e12


def bound_s(ops: float, n_bytes: float, ops_s: float) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(ops / ops_s, n_bytes / HBM_BYTES_S)
