"""Tiered order functions as lexicographic key stacks (the port of
kube_arbitrator_tpu/ops/ordering.py:30-142).

Each enabled plugin contributes key columns; ordering is a lexicographic
argmin over the stacked columns (ops/common.lex_argmin):

* priority  — job: -priority; task: -pod priority
* gang      — [ready? 1 : 0], then [ready? 0 : creation_rank + 1]
* drf       — job dominant share ascending
* proportion— queue share ascending

The creation/UID rank is always the last column.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PluginOption:
    """Per-plugin enable flags plus an ``arguments`` key/value list."""

    name: str
    job_order_disabled: bool = False
    task_order_disabled: bool = False
    queue_order_disabled: bool = False
    preemptable_disabled: bool = False
    reclaimable_disabled: bool = False
    predicate_disabled: bool = False
    job_ready_disabled: bool = False
    arguments: Tuple[Tuple[str, str], ...] = ()

    @classmethod
    def of(cls, name: str, **kw) -> "PluginOption":
        return cls(name=name, **kw)

    def arg(self, key: str, default: str = "") -> str:
        for k, v in self.arguments:
            if k == key:
                return v
        return default


@dataclasses.dataclass(frozen=True)
class Tier:
    plugins: Tuple[PluginOption, ...]


Tiers = Tuple[Tier, ...]

# Default configuration (kube-batch pkg/scheduler/util.go:30-40).
DEFAULT_TIERS: Tiers = (
    Tier(plugins=(PluginOption.of("priority"), PluginOption.of("gang"))),
    Tier(
        plugins=(
            PluginOption.of("drf"),
            PluginOption.of("predicates"),
            PluginOption.of("proportion"),
        )
    ),
)
DEFAULT_ACTIONS: Tuple[str, ...] = ("allocate", "backfill")


def job_order_keys(
    tiers: Tiers,
    job_priority: torch.Tensor,
    job_ready: torch.Tensor,
    job_creation_rank: torch.Tensor,
    job_share: torch.Tensor,
) -> List[torch.Tensor]:
    keys: List[torch.Tensor] = []
    f32 = torch.float32
    for tier in tiers:
        for p in tier.plugins:
            if p.job_order_disabled:
                continue
            if p.name == "priority":
                keys.append(-job_priority.to(f32))
            elif p.name == "gang":
                keys.append(job_ready.to(f32))
                keys.append(torch.where(job_ready, 0.0, job_creation_rank.to(f32) + 1.0))
            elif p.name == "drf":
                keys.append(job_share)
    keys.append(job_creation_rank.to(f32))
    return keys


def queue_order_keys(
    tiers: Tiers, queue_share: torch.Tensor, queue_uid_rank: torch.Tensor
) -> List[torch.Tensor]:
    keys: List[torch.Tensor] = []
    for tier in tiers:
        for p in tier.plugins:
            if p.name == "proportion" and not p.queue_order_disabled:
                keys.append(queue_share)
    keys.append(queue_uid_rank.to(torch.float32))
    return keys


NODE_ORDER_POLICIES = ("first_fit", "binpack", "spread")


def with_node_order(policy: str, tiers: Tiers = DEFAULT_TIERS) -> Tiers:
    """``tiers`` with kube-batch's nodeorder plugin set to ``policy`` (the
    plugin joins the last tier); first-fit, the default order, leaves
    ``tiers`` as they are."""
    if policy not in NODE_ORDER_POLICIES:
        raise ValueError(f"unknown nodeorder policy {policy!r}; one of {NODE_ORDER_POLICIES}")
    if policy == "first_fit":
        return tiers
    opt = PluginOption.of("nodeorder", arguments=(("policy", policy),))
    return tiers[:-1] + (Tier(plugins=tiers[-1].plugins + (opt,)),)


def node_order_policy(tiers: Tiers) -> str:
    """'first_fit' (default), 'binpack' or 'spread', from the nodeorder
    plugin's ``policy`` argument."""
    for tier in tiers:
        for p in tier.plugins:
            if p.name == "nodeorder":
                policy = p.arg("policy", "first_fit")
                if policy not in NODE_ORDER_POLICIES:
                    raise ValueError(
                        f"unknown nodeorder policy {policy!r}; one of {NODE_ORDER_POLICIES}"
                    )
                return policy
    return "first_fit"


def group_order_keys(
    tiers: Tiers, group_priority: torch.Tensor, group_uid_rank: torch.Tensor
) -> List[torch.Tensor]:
    keys: List[torch.Tensor] = []
    for tier in tiers:
        for p in tier.plugins:
            if p.name == "priority" and not p.task_order_disabled:
                keys.append(-group_priority.to(torch.float32))
    keys.append(group_uid_rank.to(torch.float32))
    return keys
