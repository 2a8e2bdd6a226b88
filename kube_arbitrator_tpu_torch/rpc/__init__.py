"""Fleet serving: the decision pool (the port of
kube_arbitrator_tpu/rpc/pool.py).  The reference's gRPC sidecar and
client (rpc/sidecar.py, rpc/client.py) are not ported; nothing here
imports grpc or protobuf."""
from .pool import (
    DecisionPool,
    PoolClient,
    PoolReplica,
    PoolShed,
    PoolUnavailable,
    TenantAdmission,
    np_equal_decisions,
    pack_shape_key,
)

__all__ = [
    "DecisionPool",
    "PoolClient",
    "PoolReplica",
    "PoolShed",
    "PoolUnavailable",
    "TenantAdmission",
    "np_equal_decisions",
    "pack_shape_key",
]
