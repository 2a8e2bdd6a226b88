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
:class:`PaFitPlan` binds an action's launches once (one launch a turn);
:func:`pa_fit` is the same through a throwaway plan.
CUDA source: csrc/pa_fit.cu.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...api.types import TaskStatus
from . import build
from .build import I, P

PENDING = int(TaskStatus.PENDING)
ALLOCATED = int(TaskStatus.ALLOCATED)
PIPELINED = int(TaskStatus.PIPELINED)

# C signature of csrc/pa_fit.cu: (static, g, g_wide, task_status, task_node, stream)
SIGNATURES = {"kat_pa_fit": (P, P, I, P, P, P)}


class _Static(ctypes.Structure):
    """csrc/pa_fit.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "snap_status", "task_valid", "task_group", "task_pa_class", "group_pa_class", "gaff",
        "ganti", "aff_key", "anti_key", "aff_static", "anti_static", "aff_static_total",
        "aff_match", "anti_match", "node_dom", "symm_ok", "dyn", "any_aff", "marks", "ticket",
        "ok_out", "seed_flags", "seed_keys", "cap_flags", "cap_keys",
    )] + [(n, ctypes.c_int) for n in ("MA", "MB", "CP", "K", "N", "D", "T", "TA", "CS")]


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


class PaFitPlan:
    """K11's launches over one action (or one turn loop) on pack ``st``.

    Built once where pod affinity is on: it checks the pack's constant
    tensors, binds the kernel's fixed arguments, keeps the stream current
    when it was built, and owns the scratch (zeroed here once; every
    launch leaves it zero) and the outputs.  A launch passes only the
    group and the two state arrays that change between turns: no cast,
    no memset, no allocation.  Its outputs are the plan's own tensors,
    OVERWRITTEN by the next launch: each caller consumes a fit (K9's
    ``pa_ok``, K12's flags and keys, K6's mask, ``_reclaim_fast``'s
    node mask) in stream order before it launches the plan again.  CPU
    packs take the plain version, into the same owned outputs."""

    def __init__(self, st):
        self.st = st
        dev = st.device
        self.dev = dev
        self.first = True
        N, D, K = st.num_nodes, st.num_domains, st.node_dom.shape[0]
        MA, MB = st.group_aff_terms.shape[1], st.group_anti_terms.shape[1]
        self.fit = PodAffinityFit(
            ok=torch.empty(N, dtype=torch.bool, device=dev),
            seed_flags=torch.empty(MA, dtype=torch.bool, device=dev),
            seed_keys=torch.empty(MA, dtype=torch.int32, device=dev),
            cap_flags=torch.empty(MB, dtype=torch.bool, device=dev),
            cap_keys=torch.empty(MB, dtype=torch.int32, device=dev),
        )
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"pa_fit: tensors on {dev}")
        TA, T = st.anti_key.shape[0], st.num_tasks
        CP = max(st.aff_match.shape[1], st.anti_match.shape[1])
        if (st.aff_match.shape[0] and st.aff_match.shape[1] != CP) or \
                (st.anti_match.shape[0] and st.anti_match.shape[1] != CP):
            raise ValueError("pa_fit: aff_match and anti_match disagree on the class axis")
        checks = [
            (st.task_status, torch.int32), (st.task_valid, torch.bool),
            (st.task_group, torch.int32), (st.task_pa_class, torch.int32),
            (st.group_pa_class, torch.int32), (st.group_aff_terms, torch.int32),
            (st.group_anti_terms, torch.int32), (st.aff_key, torch.int32),
            (st.anti_key, torch.int32), (st.aff_static, torch.int32),
            (st.anti_static, torch.int32), (st.aff_static_total, torch.int32),
            (st.aff_match, torch.bool), (st.anti_match, torch.bool), (st.node_dom, torch.int32),
            (st.symm_ok, torch.bool),
        ]
        for i, (t, dt) in enumerate(checks):
            build.require(t, dt, f"pa_fit.arg{i}", dev)
        nd = (MA + MB) * D
        # counts, any_aff, marks, ticket: zero now, and again after every launch
        self.scratch = torch.zeros(nd + MA + D + 1, dtype=torch.int32, device=dev)
        base = self.scratch.data_ptr()
        p = build.ptr
        self.static = _Static(
            p(st.task_status), p(st.task_valid), p(st.task_group), p(st.task_pa_class),
            p(st.group_pa_class), p(st.group_aff_terms), p(st.group_anti_terms), p(st.aff_key),
            p(st.anti_key), p(st.aff_static), p(st.anti_static), p(st.aff_static_total),
            p(st.aff_match), p(st.anti_match), p(st.node_dom), p(st.symm_ok),
            base, base + 4 * nd, base + 4 * (nd + MA), base + 4 * (nd + MA + D),
            p(self.fit.ok), p(self.fit.seed_flags), p(self.fit.seed_keys), p(self.fit.cap_flags),
            p(self.fit.cap_keys), MA, MB, CP, K, N, D, T, TA, st.symm_ok.shape[0],
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.fn = build.bind("pa_fit", "kat_pa_fit", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, g: torch.Tensor, task_status: torch.Tensor,
                 task_node: torch.Tensor) -> PodAffinityFit:
        """Group ``g`` (i32 / i64, its first element on the plan's
        device) against the current ``task_status`` / ``task_node``."""
        if self.dev.type == "cpu":
            for out, x in zip(self.fit, pa_fit_plain(self.st, g, task_status, task_node)):
                out.copy_(x)
            return self.fit
        if g.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"pa_fit: group dtype {g.dtype}")
        if self.first:  # the state arrays keep their types all action
            T = self.st.num_tasks
            for t, name in ((task_status, "task_status"), (task_node, "task_node")):
                build.require(t, torch.int32, f"pa_fit.{name}", self.dev)
                if t.shape != (T,):
                    raise ValueError(f"pa_fit.{name}: shape {tuple(t.shape)}, want ({T},)")
            if g.device != self.dev:
                raise ValueError(f"pa_fit: group on {g.device}")
            self.first = False
        build.check(self.fn(self.static_ptr, g.data_ptr(), int(g.dtype == torch.int64),
                            task_status.data_ptr(), task_node.data_ptr(), self.stream), "pa_fit")
        build.launched(pa_fit)
        return self.fit


def pa_fit(st, g: torch.Tensor, task_status: torch.Tensor, task_node: torch.Tensor) -> PodAffinityFit:
    """Group ``g`` (i32/i64[1], on the device) against the current
    ``task_status`` / ``task_node``, through a plan of its own (fresh
    outputs).  CPU tensors take the plain version; CUDA tensors launch
    the kernel once."""
    if task_status.device.type == "cpu":
        return pa_fit_plain(st, g, task_status, task_node)
    return PaFitPlan(st)(g, task_status, task_node)


pa_fit.launches = 0
