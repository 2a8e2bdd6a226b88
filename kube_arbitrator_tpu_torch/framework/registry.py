"""Action and plugin registries (the port's copy of
kube_arbitrator_tpu/framework/registry.py).

Mirrors the reference's registry bootstrap (``pkg/scheduler/factory.go:34-49``
registering drf/gang/predicates/priority/proportion plugins and reclaim/
allocate/backfill/preempt actions) and the mutex-guarded registries in
``framework/plugins.go:23-66``.

Here an *action* is a staged function over (SnapshotTensors, SessionCtx,
AllocState), and a *plugin* is a named contributor of order-key columns /
verdict masks the cycle reads from the tier config (ops/ordering.py,
ops/preempt.py).  Registration exists for extensibility parity: custom
actions can be added and selected by name from the YAML conf.
"""
from __future__ import annotations

from typing import Callable, Dict

from ..ops.cycle import ACTION_KERNELS

ActionFn = Callable  # (st, sess, state, tiers, **kw) -> AllocState

_plugin_registry: Dict[str, dict] = {}


def register_action(name: str, fn: ActionFn) -> None:
    """Add a custom staged action selectable by name from the YAML conf
    (the registry backs both schedule_cycle dispatch and conf validation)."""
    ACTION_KERNELS[name] = fn


def get_action(name: str) -> ActionFn:
    if name not in ACTION_KERNELS:
        raise KeyError(f"failed to find Action {name}")
    return ACTION_KERNELS[name]


def register_plugin(name: str, capabilities: dict) -> None:
    """capabilities documents which extension points the plugin serves
    (job_order, task_order, queue_order, preemptable, reclaimable,
    predicate, job_ready, overused, node_order) — the conf loader
    validates tier plugin names against the registry and each disable
    flag against the plugin's capability set (framework/conf.py)."""
    _plugin_registry[name] = capabilities


def plugin_capabilities(name: str) -> dict:
    return _plugin_registry.get(name, {})


def registered_plugins() -> tuple:
    """Registered plugin names — the conf loader's validation domain
    (the analog of the pluginBuilders registry consulted by OpenSession,
    framework/plugins.go:23-66)."""
    return tuple(_plugin_registry)


# factory.go:34-49 equivalents: the four built-in actions are registered by
# ops/cycle.py; plugins registered here.
register_plugin("priority", {"job_order": True, "task_order": True})
register_plugin(
    "gang",
    {"job_order": True, "job_ready": True, "job_valid": True, "preemptable": True, "reclaimable": True},
)
register_plugin("drf", {"job_order": True, "preemptable": True})
register_plugin("proportion", {"queue_order": True, "reclaimable": True, "overused": True})
register_plugin("predicates", {"predicate": True})
register_plugin("nodeorder", {"node_order": True})
