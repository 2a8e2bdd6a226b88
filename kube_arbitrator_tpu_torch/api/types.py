"""Task status lattice and scheduling enums (the port's copy of
kube_arbitrator_tpu/api/types.py).

Semantics parity: reference ``pkg/scheduler/api/types.go:20-54`` and
``helpers.go:35-70``.  Statuses are small ints (not bit flags — the reference
uses ``1 << iota`` only as distinct ids) so they can live in small-int
device tensors.
"""
from __future__ import annotations

import enum


class TaskStatus(enum.IntEnum):
    PENDING = 0      # pending in the apiserver
    ALLOCATED = 1    # scheduler assigned a host (session-side)
    PIPELINED = 2    # assigned a host, waiting on releasing resources
    BINDING = 3      # bind request sent
    BOUND = 4        # bound to a host
    RUNNING = 5      # running on the host
    RELEASING = 6    # being deleted
    SUCCEEDED = 7
    FAILED = 8
    UNKNOWN = 9


# Statuses that consume node Idle resources (reference helpers.go:63-70).
ALLOCATED_STATUSES = frozenset(
    {TaskStatus.ALLOCATED, TaskStatus.BINDING, TaskStatus.BOUND, TaskStatus.RUNNING}
)


def is_allocated_status(s: TaskStatus) -> bool:
    return s in ALLOCATED_STATUSES


# Statuses counted toward gang readiness (reference gang.go:44-70):
# allocated-statuses + Succeeded + Pipelined.  (Pending additionally counts
# toward *valid* tasks for JobValid.)
def counts_as_ready(s: TaskStatus) -> bool:
    return is_allocated_status(s) or s in (TaskStatus.SUCCEEDED, TaskStatus.PIPELINED)


def counts_as_valid(s: TaskStatus) -> bool:
    return counts_as_ready(s) or s == TaskStatus.PENDING


class PodGroupPhase(enum.IntEnum):
    """Reference pkg/apis/scheduling/v1alpha1/types.go:28-39."""

    PENDING = 0
    RUNNING = 1
    UNKNOWN = 2


# PodGroup condition type (reference v1alpha1/types.go:41-45).
COND_UNSCHEDULABLE = "Unschedulable"
