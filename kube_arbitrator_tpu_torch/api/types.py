"""Task status lattice (values copied from the reference's api/types.py,
kube-batch ``pkg/scheduler/api/types.go:20-54``)."""
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
