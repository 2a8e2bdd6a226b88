"""The scheduler configuration the port decides with (the port of
kube_arbitrator_tpu/framework/conf.py's ``SchedulerConfig``).

:func:`from_config` reads any object with ``.actions`` and ``.tiers``
(the reference's ``SchedulerConfig`` among them) attribute by attribute
into the port's :class:`Tier` / :class:`PluginOption` values.  Loading
the YAML conf is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..ops.cycle import ACTION_KERNELS
from ..ops.ordering import DEFAULT_ACTIONS, DEFAULT_TIERS, PluginOption, Tier, Tiers

_FLAGS = tuple(f.name for f in dataclasses.fields(PluginOption) if f.name not in ("name", "arguments"))


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    actions: Tuple[str, ...]
    tiers: Tiers

    @classmethod
    def default(cls) -> "SchedulerConfig":
        return cls(actions=DEFAULT_ACTIONS, tiers=DEFAULT_TIERS)


def _plugin(p) -> PluginOption:
    flags = {f: bool(getattr(p, f)) for f in _FLAGS if hasattr(p, f)}
    args = tuple((str(k), str(v)) for k, v in getattr(p, "arguments", ()) or ())
    return PluginOption(name=str(p.name), arguments=args, **flags)


def from_config(obj) -> SchedulerConfig:
    """A port config from ``obj.actions`` and ``obj.tiers`` (each tier's
    ``.plugins``, each plugin's name, enable flags and ``arguments``
    pairs).  An action the port does not run raises."""
    if isinstance(obj, SchedulerConfig):
        return obj
    actions = tuple(str(a) for a in obj.actions)
    unknown = [a for a in actions if a not in ACTION_KERNELS]
    if unknown:
        raise ValueError(f"unknown actions {unknown}; the port runs {sorted(ACTION_KERNELS)}")
    tiers = tuple(Tier(plugins=tuple(_plugin(p) for p in t.plugins)) for t in obj.tiers)
    return SchedulerConfig(actions=actions, tiers=tiers)
