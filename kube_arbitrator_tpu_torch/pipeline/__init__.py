"""Pipelined cycle plane: the arena's epochs, speculative decide,
commit-time revalidation (the port of kube_arbitrator_tpu/pipeline).

kube-batch's session is strictly sequential — snapshot, kernel, decode,
commit, repeat — so its cadence is sum(stages).  This package runs the
stages as an overlapped pipeline over the incremental snapshot arena
(cache/arena.py): epoch E ingests watch deltas on the ingest thread while
the decide worker runs the decider on the frozen epoch E-1, and every
speculative decision passes a revalidate-or-discard gate against the
deltas that arrived mid-flight before it actuates.

Entry points: ``Scheduler.run_pipelined`` (framework/scheduler.py) and
the CLI's ``--pipeline`` flag.
"""
from .executor import PIPELINE_STAGES, PipelinedExecutor, StepOutcome
from .journal import DeltaJournal
from .revalidate import DISCARD_REASONS, Discard, revalidate_batch, revalidate_decisions

__all__ = [
    "PIPELINE_STAGES",
    "PipelinedExecutor",
    "StepOutcome",
    "DeltaJournal",
    "DISCARD_REASONS",
    "Discard",
    "revalidate_batch",
    "revalidate_decisions",
]
