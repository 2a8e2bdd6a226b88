"""The scheduler-facing serving path: the port's configuration and the
decider a scheduler's session calls each cycle."""
from .conf import SchedulerConfig, from_config
from .decider import TorchDecider

__all__ = ["SchedulerConfig", "TorchDecider", "from_config"]
