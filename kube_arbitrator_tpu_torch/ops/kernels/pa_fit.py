"""K11 ``pa_fit``: one turn's pod-(anti-)affinity fit of group ``g``.

Replaces ops/podaffinity.py:pod_affinity_fit (:73-170) of the reference:
the per-domain counts of this cycle's placed pods for each of the
group's terms, the ok mask over nodes (affinity with its first-pod case,
anti-affinity, dynamic symmetry over the placed pods' own anti terms,
the static symmetry table ``symm_ok``) and the group's seed / cap flags.
Everything is integer, so the kernel's atomics are exact in any order.
Dynamic symmetry marks domains on the pack's global domain axis (each
domain ordinal belongs to one topology key), so the placed pods' terms
are visited once each rather than once per anti term of the pack.
CUDA source: csrc/pa_fit.cu.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...api.types import TaskStatus
from . import build
from .build import I, P

PENDING = int(TaskStatus.PENDING)
ALLOCATED = int(TaskStatus.ALLOCATED)
PIPELINED = int(TaskStatus.PIPELINED)

# C signature of csrc/pa_fit.cu
SIGNATURES = {
    "kat_pa_fit": (
        P, P, P, P, P, P, P, P, P, I, P, I, P, P, P, P, P, P, P, I, P, I, I, I, I, I, P, I,
        P, P, P, P, P, P, P, P, P,
    ),
}


class PodAffinityFit(NamedTuple):
    """A group's fit for one turn.  A group may carry several
    self-referential terms over different topology keys; apply_seed /
    apply_domain_cap fold over all of them."""

    ok: torch.Tensor          # bool[N] nodes admissible for the group
    seed_flags: torch.Tensor  # bool[MA] per aff term: restrict the turn to ONE domain
    seed_keys: torch.Tensor   # i32[MA] topology-key row per aff term
    cap_flags: torch.Tensor   # bool[MB] per anti term: one per domain
    cap_keys: torch.Tensor    # i32[MB] topology-key row per anti term


def _placed(st, task_status, task_node):
    """bool[T]: pods placed earlier this cycle (PENDING in the snapshot)."""
    return (
        (st.task_status == PENDING)
        & ((task_status == ALLOCATED) | (task_status == PIPELINED))
        & (task_node >= 0)
        & st.task_valid
    )


def pa_fit_plain(st, g, task_status, task_node) -> PodAffinityFit:
    """The plain version: the reference's fit term by term (the dynamic
    symmetry as domain marks, which equals its per-term blocks)."""
    N, D, K = st.num_nodes, st.num_domains, st.node_dom.shape[0]
    MA, MB = st.group_aff_terms.shape[1], st.group_anti_terms.shape[1]
    TA = st.anti_key.shape[0]
    dev = task_status.device
    gi = g.reshape(-1)[:1].to(torch.int64)
    cp = st.task_pa_class.to(torch.int64)
    cpg = st.group_pa_class[gi].to(torch.int64)          # [1]
    placed = _placed(st, task_status, task_node)
    tnode = task_node.clamp(min=0).to(torch.int64)
    ok = torch.ones(N, dtype=torch.bool, device=dev)

    def dom_of(key):  # key i64[1] -> i64[N] domains of that key
        return st.node_dom[key.to(torch.int64)][0].to(torch.int64)

    def dyn_count(ndom, contrib):
        tdom = ndom[tnode]
        live = contrib & placed & (tdom >= 0)
        hits = torch.zeros(D + 1, dtype=torch.int32, device=dev)
        hits.scatter_add_(0, torch.where(live, tdom, D), torch.ones_like(tdom, dtype=torch.int32))
        return hits[:D]

    seed_flags, seed_keys, cap_flags, cap_keys = [], [], [], []
    for m in range(MA):
        t = st.group_aff_terms[gi, m]
        tv = t >= 0
        tc = t.clamp(min=0).to(torch.int64)
        key = st.aff_key[tc]
        ndom = dom_of(key)
        dyn = dyn_count(ndom, st.aff_match[tc][0][cp])
        tot = st.aff_static[tc][0] + dyn
        any_match = (st.aff_static_total[tc] > 0) | (dyn > 0).any()
        self_seed = tv & ~any_match & st.aff_match[tc, cpg]
        ok_t = (ndom >= 0) & ((tot[ndom.clamp(min=0)] > 0) | self_seed)
        ok = ok & torch.where(tv, ok_t, True)
        seed_flags.append(self_seed)
        seed_keys.append(key)
    for m in range(MB):
        t = st.group_anti_terms[gi, m]
        tv = t >= 0
        tc = t.clamp(min=0).to(torch.int64)
        key = st.anti_key[tc]
        ndom = dom_of(key)
        dyn = dyn_count(ndom, st.anti_match[tc][0][cp])
        tot = st.anti_static[tc][0] + dyn
        blocked = (ndom >= 0) & (tot[ndom.clamp(min=0)] > 0)
        ok = ok & torch.where(tv, ~blocked, True)
        cap_flags.append(tv & st.anti_match[tc, cpg])
        cap_keys.append(key)
    if TA > 0:
        t_terms = st.group_anti_terms[st.task_group.clamp(min=0).to(torch.int64)]  # [T, MB]
        marks = torch.zeros(D + 1, dtype=torch.bool, device=dev)
        for m in range(MB):
            ti = t_terms[:, m]
            tic = ti.clamp(min=0).to(torch.int64)
            tdom = st.node_dom[st.anti_key[tic].to(torch.int64), tnode].to(torch.int64)
            live = ((ti >= 0) & (st.task_group >= 0) & placed & st.anti_match[tic, cpg]
                    & (tdom >= 0))
            marks[torch.where(live, tdom, D)] = True
        marks = marks[:D]
        for k in range(K):
            nd = st.node_dom[k].to(torch.int64)
            ok = ok & ~((nd >= 0) & marks[nd.clamp(min=0)])
    CS = st.symm_ok.shape[0]
    if CS > 0:
        ok = ok & st.symm_ok[cpg.clamp(0, CS - 1)][0]

    def stack(xs, dtype):
        if not xs:
            return torch.zeros(0, dtype=dtype, device=dev)
        return torch.cat([x.reshape(1) for x in xs]).to(dtype)

    return PodAffinityFit(ok=ok, seed_flags=stack(seed_flags, torch.bool),
                          seed_keys=stack(seed_keys, torch.int32),
                          cap_flags=stack(cap_flags, torch.bool),
                          cap_keys=stack(cap_keys, torch.int32))


def pa_fit(st, g: torch.Tensor, task_status: torch.Tensor, task_node: torch.Tensor) -> PodAffinityFit:
    """Group ``g`` (i32/i64[1], on the device) against the current
    ``task_status`` / ``task_node``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (two grids: tasks, then nodes)."""
    if task_status.device.type == "cpu":
        return pa_fit_plain(st, g, task_status, task_node)
    dev = task_status.device
    if dev.type != "cuda":
        raise ValueError(f"pa_fit: tensors on {dev}")
    N, D, K = st.num_nodes, st.num_domains, st.node_dom.shape[0]
    MA, MB = st.group_aff_terms.shape[1], st.group_anti_terms.shape[1]
    TA, T = st.anti_key.shape[0], st.num_tasks
    CP = max(st.aff_match.shape[1], st.anti_match.shape[1])
    if (st.aff_match.shape[0] and st.aff_match.shape[1] != CP) or \
            (st.anti_match.shape[0] and st.anti_match.shape[1] != CP):
        raise ValueError("pa_fit: aff_match and anti_match disagree on the class axis")
    g32 = g.reshape(-1)[:1].to(torch.int32).contiguous()
    checks = [
        (st.task_status, torch.int32), (task_status, torch.int32), (task_node, torch.int32),
        (st.task_valid, torch.bool), (st.task_group, torch.int32),
        (st.task_pa_class, torch.int32), (st.group_pa_class, torch.int32),
        (st.group_aff_terms, torch.int32), (st.group_anti_terms, torch.int32),
        (st.aff_key, torch.int32), (st.anti_key, torch.int32), (st.aff_static, torch.int32),
        (st.anti_static, torch.int32), (st.aff_static_total, torch.int32),
        (st.aff_match, torch.bool), (st.anti_match, torch.bool), (st.node_dom, torch.int32),
        (st.symm_ok, torch.bool),
    ]
    for i, (t, dt) in enumerate(checks):
        build.require(t, dt, f"pa_fit.arg{i}", dev)
    scratch = torch.zeros((MA + MB) * D + MA + D, dtype=torch.int32, device=dev)
    dyn = scratch[: (MA + MB) * D]
    any_aff = scratch[(MA + MB) * D: (MA + MB) * D + MA]
    marks = scratch[(MA + MB) * D + MA:]
    ok = torch.empty(N, dtype=torch.bool, device=dev)
    seed_flags = torch.empty(MA, dtype=torch.bool, device=dev)
    seed_keys = torch.empty(MA, dtype=torch.int32, device=dev)
    cap_flags = torch.empty(MB, dtype=torch.bool, device=dev)
    cap_keys = torch.empty(MB, dtype=torch.int32, device=dev)
    fn = build.bind("pa_fit", "kat_pa_fit", SIGNATURES)
    p = build.ptr
    build.check(fn(
        p(g32), p(st.task_status), p(task_status), p(task_node), p(st.task_valid),
        p(st.task_group), p(st.task_pa_class), p(st.group_pa_class), p(st.group_aff_terms), MA,
        p(st.group_anti_terms), MB, p(st.aff_key), p(st.anti_key), p(st.aff_static),
        p(st.anti_static), p(st.aff_static_total), p(st.aff_match), p(st.anti_match), CP,
        p(st.node_dom), K, N, D, T, TA, p(st.symm_ok), st.symm_ok.shape[0], p(dyn), p(any_aff),
        p(marks), p(ok), p(seed_flags), p(seed_keys), p(cap_flags), p(cap_keys), build.stream(),
    ), "pa_fit")
    pa_fit.launches += 2 if T > 0 else 1
    return PodAffinityFit(ok=ok, seed_flags=seed_flags, seed_keys=seed_keys,
                          cap_flags=cap_flags, cap_keys=cap_keys)


pa_fit.launches = 0
