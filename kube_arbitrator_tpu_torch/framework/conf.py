"""The scheduler configuration: YAML parity with the reference (the port
of kube_arbitrator_tpu/framework/conf.py).

Format (reference ``pkg/scheduler/conf/scheduler_conf.go:20-50``, default
``pkg/scheduler/util.go:30-40``):

    actions: "allocate, backfill"
    tiers:
    - plugins:
      - name: priority
      - name: gang
    - plugins:
      - name: drf
        disableJobOrder: true
      - name: predicates
      - name: proportion

:func:`load_conf` / :func:`dump_conf` read and write it; each imports
``yaml`` when called, so importing the port never needs PyYAML, and
:meth:`SchedulerConfig.default` is built in code.  :func:`from_config`
reads any object with ``.actions`` and ``.tiers`` (the reference's
``SchedulerConfig`` among them) attribute by attribute into the port's
:class:`Tier` / :class:`PluginOption` values.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..ops.cycle import ACTION_KERNELS
from ..ops.ordering import DEFAULT_ACTIONS, DEFAULT_TIERS, PluginOption, Tier, Tiers

DEFAULT_CONF = """
actions: "allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
"""

_FLAG_KEYS = {
    "disableJobOrder": "job_order_disabled",
    "disableJobReady": "job_ready_disabled",
    "disableTaskOrder": "task_order_disabled",
    "disablePreemptable": "preemptable_disabled",
    "disableReclaimable": "reclaimable_disabled",
    "disableQueueOrder": "queue_order_disabled",
    "disablePredicate": "predicate_disabled",
}

# disable flag -> the registry capability it gates (registry.py documents
# each plugin's extension points; a flag on a plugin that never serves the
# point is a conf bug, not a no-op)
_FLAG_CAPABILITY = {
    "disableJobOrder": "job_order",
    "disableJobReady": "job_ready",
    "disableTaskOrder": "task_order",
    "disablePreemptable": "preemptable",
    "disableReclaimable": "reclaimable",
    "disableQueueOrder": "queue_order",
    "disablePredicate": "predicate",
}


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


def load_conf(conf_str: str) -> SchedulerConfig:
    """YAML string -> SchedulerConfig (loadSchedulerConf, util.go:42-64).
    Unknown actions are an error, like the reference."""
    import yaml  # lazily: importing the port never needs PyYAML

    from .registry import plugin_capabilities, registered_plugins

    raw = yaml.safe_load(conf_str) or {}
    action_names = tuple(
        a.strip() for a in str(raw.get("actions", "allocate, backfill")).split(",") if a.strip()
    )
    for a in action_names:
        if a not in ACTION_KERNELS:
            raise ValueError(f"failed to find Action {a}")
    tiers = []
    for tier_raw in raw.get("tiers", []) or []:
        plugins = []
        for p in tier_raw.get("plugins", []) or []:
            name = p.get("name", "")
            if name not in registered_plugins():
                raise ValueError(f"unknown plugin {name}")
            caps = plugin_capabilities(name)
            for yk in _FLAG_KEYS:
                if yk in p and not caps.get(_FLAG_CAPABILITY[yk]):
                    raise ValueError(
                        f"plugin {name} does not serve the "
                        f"{_FLAG_CAPABILITY[yk]} extension point; {yk} is "
                        f"meaningless (capabilities: {sorted(caps)})"
                    )
            kwargs = {attr: bool(p[yk]) for yk, attr in _FLAG_KEYS.items() if yk in p}
            args = p.get("arguments") or {}
            if args:
                kwargs["arguments"] = tuple(sorted((str(k), str(v)) for k, v in args.items()))
            opt = PluginOption(name=name, **kwargs)
            if name == "nodeorder":
                from ..ops.ordering import node_order_policy

                node_order_policy((Tier(plugins=(opt,)),))  # validates policy
            plugins.append(opt)
        tiers.append(Tier(plugins=tuple(plugins)))
    return SchedulerConfig(actions=action_names, tiers=tuple(tiers))


def load_conf_file(path: str) -> SchedulerConfig:
    with open(path) as f:
        return load_conf(f.read())


def dump_conf(config: SchedulerConfig) -> str:
    """SchedulerConfig -> YAML string accepted by load_conf (the
    reference's :123)."""
    import yaml

    tiers = []
    for tier in config.tiers:
        plugins = []
        for p in tier.plugins:
            entry = {"name": p.name}
            for yk, attr in _FLAG_KEYS.items():
                if getattr(p, attr):
                    entry[yk] = True
            if p.arguments:
                entry["arguments"] = {k: v for k, v in p.arguments}
            plugins.append(entry)
        tiers.append({"plugins": plugins})
    return yaml.safe_dump(
        {"actions": ", ".join(config.actions), "tiers": tiers}, sort_keys=False
    )
