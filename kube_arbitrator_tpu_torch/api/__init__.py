"""Scheduler API data model (snapshot plane): the port's copy of
kube_arbitrator_tpu/api."""
from . import resource
from .info import (
    ClusterInfo,
    JobInfo,
    MatchExpression,
    NodeInfo,
    PodAffinityTerm,
    QueueInfo,
    Taint,
    TaskInfo,
    Toleration,
)
from .types import (
    ALLOCATED_STATUSES,
    COND_UNSCHEDULABLE,
    PodGroupPhase,
    TaskStatus,
    counts_as_ready,
    counts_as_valid,
    is_allocated_status,
)

__all__ = [
    "resource",
    "ClusterInfo",
    "JobInfo",
    "MatchExpression",
    "NodeInfo",
    "PodAffinityTerm",
    "QueueInfo",
    "Taint",
    "TaskInfo",
    "Toleration",
    "TaskStatus",
    "PodGroupPhase",
    "ALLOCATED_STATUSES",
    "COND_UNSCHEDULABLE",
    "counts_as_ready",
    "counts_as_valid",
    "is_allocated_status",
]
