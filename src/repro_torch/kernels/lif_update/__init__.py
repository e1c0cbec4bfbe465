from .ops import (
    MAX_EDGES,
    CurrentEdge,
    RingEdge,
    empty_launch,
    lif_step,
    lif_step_ref,
    lif_update,
    lif_update_ref,
    ring_deliver_ref,
)
