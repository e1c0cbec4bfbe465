from .ops import (
    spike_wdm_matmul,
    spike_wdm_matmul_ref,
    spike_wdm_project,
    spike_wdm_project_ref,
    stream_tiling,
    wdm_design,
)
