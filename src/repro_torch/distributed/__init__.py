from .sharding import (
    MULTI_CARD_ITEM, placement_put, snn_mesh, snn_rules, visible_cards,
)
from .fault_tolerance import (
    FaultTolerantDriver, HeartbeatRegistry, HostFailure, RestartPolicy,
    StragglerDetector, plan_elastic_mesh,
)
