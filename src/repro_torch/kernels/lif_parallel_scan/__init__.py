from .ops import (
    lif_fixed_point,
    lif_fixed_point_launch,
    lif_fixed_point_ref,
    lif_parallel_scan,
    lif_parallel_scan_ref,
    shared_words_limit,
    staged_steps_limit,
)
