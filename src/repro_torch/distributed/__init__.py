"""The port of ``repro.distributed``.

``sharding`` holds the logical-axis rules engine, the SNN mesh and the
placement put; ``exchange`` the exact collectives the SPMD paths run
between ranks (one process a card over ``torch.distributed``), which the
reference's single controller and GSPMD run without being asked;
``fault_tolerance`` the host-side failure bookkeeping.

The reference's ``compat.py`` is a shim that picks ``jax.shard_map``'s
API across JAX versions.  It has no torch meaning, so it is not copied:
the port's collectives are written out in ``exchange``.
"""
from .exchange import exchange_counts, reset_exchange_counts, transport
from .sharding import (
    NamedSharding, PartitionSpec, constrain, gather_tree, make_rules,
    mesh_sizes, placement_put, shard_tree, sharding_ctx, snn_mesh, snn_rules,
    spec_for, spec_for_shape, tree_shardings, visible_cards,
)
from .fault_tolerance import (
    FaultTolerantDriver, HeartbeatRegistry, HostFailure, RestartPolicy,
    StragglerDetector, plan_elastic_mesh,
)
