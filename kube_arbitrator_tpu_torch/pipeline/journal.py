"""The delta journal: what changed inside the speculation window (the
port's copy of kube_arbitrator_tpu/pipeline/journal.py).

When the pipelined executor freezes epoch E and hands it to the decide
worker, the cluster model keeps moving — watch deltas, resync repairs,
foreign churn.  Decisions computed from the frozen pack are therefore
*speculative*: each one must be re-checked at commit time against
whatever arrived mid-flight.  The journal is the record of exactly that
window: the arena tees every delta-sink call into it (in addition to its
own dirty sets, which the next pack consumes), and the executor resets
it at each freeze, so between a freeze and its commit the journal holds
precisely the deltas the frozen epoch could not see.

The revalidation gate (:mod:`.revalidate`) uses it to bound work: a
bind/evict whose task and node appear nowhere in the journal committed
against state identical to what the decider saw and passes untouched —
on a quiescent stream the gate is a no-op and pipelined runs produce
bit-identical decision streams to sequential ones.  A structural event
(set membership, relist) makes the window unclassifiable row-wise and
flips the gate to conservative full revalidation.

Thread discipline: written by the ingest thread, read by the commit
gate — both the scheduler's main thread.  The decide worker never
touches it, so no lock is needed.
"""
from __future__ import annotations

from typing import Dict, List, Set


class DeltaJournal:
    """Deltas that arrived after the last freeze (see module docstring)."""

    __slots__ = ("dirty_tasks", "dirty_nodes", "structural", "events")

    def __init__(self) -> None:
        self.dirty_tasks: Set[str] = set()
        self.dirty_nodes: Set[str] = set()
        self.structural: List[str] = []
        self.events = 0

    # ---- the sink surface (the arena tees into these) ----

    def task_dirty(self, uid: str, node_name: str = "") -> None:
        self.dirty_tasks.add(uid)
        if node_name:
            self.dirty_nodes.add(node_name)
        self.events += 1

    def task_dirty_rows(self, uids, node_names=()) -> None:
        """Batched twin of :meth:`task_dirty`: parallel uid/node vectors
        from a columnar producer (batched ingest blocks, columnar
        actuation).  Set semantics and the event count match the
        equivalent scalar call sequence exactly."""
        self.dirty_tasks.update(uids)
        self.dirty_nodes.update(n for n in node_names if n)
        self.events += len(uids)

    def node_dirty(self, name: str) -> None:
        self.dirty_nodes.add(name)
        self.events += 1

    def structural_event(self, reason: str) -> None:
        self.structural.append(reason)
        self.events += 1

    # ---- window management (the executor) ----

    def reset(self) -> None:
        """A new speculation window opens (the epoch just froze)."""
        self.dirty_tasks.clear()
        self.dirty_nodes.clear()
        self.structural.clear()
        self.events = 0

    @property
    def empty(self) -> bool:
        return not (self.dirty_tasks or self.dirty_nodes or self.structural)

    def summary(self) -> Dict[str, int]:
        """Counts for bench/debug rows."""
        return {
            "dirty_tasks": len(self.dirty_tasks),
            "dirty_nodes": len(self.dirty_nodes),
            "structural": len(self.structural),
            "events": self.events,
        }
