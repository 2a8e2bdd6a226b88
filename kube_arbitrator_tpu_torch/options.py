"""Process-wide scheduler options (the port's copy of
kube_arbitrator_tpu/options.py).

Reference ``cmd/kube-batch/app/options/options.go:27-84``: a pflag-backed
``ServerOption`` singleton (``Options()`` at :44-49) that is also consulted
deep in the data model — ``JobInfo.SetPodGroup``/``SetPDB`` resolve a job's
queue through ``Options().DefaultQueue`` / ``NamespaceAsQueue``
(``api/job_info.go:166-199``).  The same pattern here: a module-level
singleton the CLI populates and the sim/job model reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ServerOptions:
    scheduler_name: str = "kube-batch"
    schedule_period_s: float = 1.0
    default_queue: str = "default"
    # --enable-namespace-as-queue: queues are namespaces (weight 1) instead
    # of Queue CRD objects (cache.go:290-306).
    namespace_as_queue: bool = False
    scheduler_conf: str = ""
    enable_leader_election: bool = False
    lock_object_namespace: str = ""
    print_version: bool = False

    def check(self) -> None:
        """CheckOptionOrDie (options.go:76-84)."""
        if self.enable_leader_election and not self.lock_object_namespace:
            raise ValueError(
                "lock_object_namespace is required when leader election is enabled"
            )


_options: Optional[ServerOptions] = None


def options() -> ServerOptions:
    """The singleton accessor (options.go:44-49); creates defaults lazily."""
    global _options
    if _options is None:
        _options = ServerOptions()
    return _options


def set_options(opts: ServerOptions) -> ServerOptions:
    global _options
    _options = opts
    return opts


def reset_options() -> None:
    """Test helper: restore defaults."""
    global _options
    _options = None
