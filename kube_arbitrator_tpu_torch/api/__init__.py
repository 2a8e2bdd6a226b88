from . import resource
from .types import TaskStatus

__all__ = ["TaskStatus", "resource"]
