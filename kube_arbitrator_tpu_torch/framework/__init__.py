"""Framework: the scheduler loop, its session, the conf and registries,
the decider a session calls each cycle (``TorchDecider``) and leader
election."""
from ..options import ServerOptions, options, reset_options, set_options
from .conf import DEFAULT_CONF, SchedulerConfig, dump_conf, from_config, load_conf, load_conf_file
from .decider import TorchDecider
from .leader import ApiLeaderElector, LeaderElector, LeaderLost, TransientLockError
from .registry import get_action, plugin_capabilities, register_action, register_plugin
from .scheduler import CycleStats, Scheduler, classify_cycle_error
from .session import CycleResult, PodGroupCondition, PodGroupStatus, Session

__all__ = [
    "DEFAULT_CONF",
    "SchedulerConfig",
    "dump_conf",
    "from_config",
    "load_conf",
    "load_conf_file",
    "get_action",
    "register_action",
    "register_plugin",
    "plugin_capabilities",
    "Scheduler",
    "CycleStats",
    "classify_cycle_error",
    "Session",
    "CycleResult",
    "PodGroupCondition",
    "PodGroupStatus",
    "ServerOptions",
    "TorchDecider",
    "LeaderElector",
    "ApiLeaderElector",
    "LeaderLost",
    "TransientLockError",
    "options",
    "set_options",
    "reset_options",
]
