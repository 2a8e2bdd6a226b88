"""K12 ``pa_shape``: the pod-affinity shaping of one turn's capacity.

Replaces ops/podaffinity.py:apply_seed (:173-193) and apply_domain_cap
(:196-227) of the reference, folded in order, seed terms first: a seed
term keeps only the first domain (of its key) with the largest capacity
sum; a cap term keeps, per domain, the first position in packing order
with capacity > 0, at one copy.  Rows are per-node capacities in packing
order (``nperm``: node at each position, or None for node order), shaped
IN PLACE: the immediate allocate turn shapes K9's idle and releasing
rows, preempt's claim its claim capacity between K6's two launches.

:class:`PaShapePlan` binds an action's launches once; :func:`pa_shape` is
the same on a copy of its rows, through a throwaway plan.
CUDA source: csrc/pa_shape.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .build import I, P

# the domain scratch in dynamic shared memory up to this many domains
# (192 KB), in a global per-row scratch past it
SMEM_MAX_D = 49_152
SCRATCH = ("shared", "global")

# C signature of csrc/pa_shape.cu: (static, rows or null, row count, stream)
SIGNATURES = {"kat_pa_shape": (P, P, I, P)}


class _Static(ctypes.Structure):
    """csrc/pa_shape.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "k", "nperm", "node_dom", "seed_flags", "seed_keys", "cap_flags", "cap_keys", "scratch",
    )] + [(n, ctypes.c_int) for n in ("rows", "N", "D", "MA", "MB")]


def apply_seed(st, fit, k: torch.Tensor, nperm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """i32[..., N]: every seed term of ``fit`` folded over ``k`` (rows
    shaped independently)."""
    if st.node_dom.shape[0] == 0:
        return k
    D = st.num_domains
    rows = k.reshape(-1, k.shape[-1])
    out = []
    for row in rows:
        for m in range(fit.seed_flags.shape[0]):
            ndom = st.node_dom[fit.seed_keys[m].to(torch.int64)].to(torch.int64)
            if nperm is not None:
                ndom = ndom[nperm.to(torch.int64)]
            dom_cap = torch.zeros(D + 1, dtype=row.dtype, device=row.device)
            dom_cap.scatter_add_(0, torch.where(ndom >= 0, ndom, D), row)
            best = torch.argmax(dom_cap[:D])  # the first maximum
            row = torch.where(fit.seed_flags[m], torch.where(ndom == best, row, 0), row)
        out.append(row)
    return torch.stack(out).reshape(k.shape)


def apply_domain_cap(st, fit, k: torch.Tensor, nperm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """i32[..., N] in packing order: every cap term of ``fit`` folded over
    ``k`` — per domain, the first position with k > 0 keeps one copy."""
    if st.node_dom.shape[0] == 0:
        return k
    D = st.num_domains
    rows = k.reshape(-1, k.shape[-1])
    N = rows.shape[1]
    pos = torch.arange(N, device=k.device)
    out = []
    for row in rows:
        for m in range(fit.cap_flags.shape[0]):
            ndom = st.node_dom[fit.cap_keys[m].to(torch.int64)].to(torch.int64)
            if nperm is not None:
                ndom = ndom[nperm.to(torch.int64)]
            first = torch.full((D + 1,), N, dtype=torch.int64, device=k.device)
            first.scatter_reduce_(0, torch.where((ndom >= 0) & (row > 0), ndom, D), pos, "amin")
            keep = (row > 0) & (first[ndom.clamp(min=0)] == pos)
            capped = torch.where(ndom >= 0, keep.to(row.dtype), row)
            row = torch.where(fit.cap_flags[m], capped, row)
        out.append(row)
    return torch.stack(out).reshape(k.shape)


def pa_shape_plain(st, fit, k, nperm=None):
    """The plain version: seeds, then caps, as the reference folds them."""
    return apply_domain_cap(st, fit, apply_seed(st, fit, k, nperm), nperm)


class PaShapePlan:
    """K12's launches over one action on pack ``st``.

    ``fit`` is the fit whose seed / cap flags and keys every launch
    reads: K11's plan-owned :class:`PodAffinityFit` (``PaFitPlan.fit``),
    overwritten in place turn by turn.  With ``k`` (i32[rows, N], K9's
    plan-owned capacity rows, in the packing order ``nperm``: K9's
    plan-owned order, or None for node order) a launch passes nothing and
    shapes ``k`` in place; without it a launch passes one row i32[N] in
    node order (preempt's claim capacity) and shapes that row in place.
    Built once where the turn loop starts: it checks the tensors once,
    binds the kernel's fixed arguments, keeps the stream current when it
    was built, raises the shared-memory limit once per process and owns
    the global domain scratch where D outgrows shared memory.  No
    allocation or bind per launch; a passed row is checked at the first.
    ``scratch`` forces a route of :data:`SCRATCH` (default: shared up to
    :data:`SMEM_MAX_D` domains).  CPU tensors take the plain version
    (into the same rows)."""

    def __init__(self, st, fit, k: Optional[torch.Tensor] = None,
                 nperm: Optional[torch.Tensor] = None, scratch: Optional[str] = None):
        N, D = st.num_nodes, st.num_domains
        self.st, self.fit, self.k, self.nperm = st, fit, k, nperm
        self.noop = st.node_dom.shape[0] == 0
        self.scratch_route = scratch or ("shared" if D <= SMEM_MAX_D else "global")
        if self.scratch_route not in SCRATCH:
            raise ValueError(f"pa_shape: scratch {scratch!r}")
        if k is None and nperm is not None:
            raise ValueError("pa_shape: a packing order needs the bound rows")
        if k is not None and (k.dim() != 2 or k.shape[1] != N):
            raise ValueError(f"pa_shape: k must be i32[rows, {N}]")
        if nperm is not None and nperm.shape != (N,):
            raise ValueError("pa_shape: node axes disagree")
        self.rows = 1 if k is None else k.shape[0]
        dev = st.node_dom.device
        self.dev, self.first = dev, True
        if dev.type == "cpu" or self.noop:
            return
        if dev.type != "cuda":
            raise ValueError(f"pa_shape: tensors on {dev}")
        if N >= 1 << 24 or fit.cap_flags.shape[0] > 127:
            raise ValueError("pa_shape: the cap stamps hold N < 2^24 and at most 127 cap terms")
        checks = [(st.node_dom, torch.int32), (fit.seed_flags, torch.bool),
                  (fit.seed_keys, torch.int32), (fit.cap_flags, torch.bool),
                  (fit.cap_keys, torch.int32)]
        checks += [(t, torch.int32) for t in (k, nperm) if t is not None]
        for i, (t, dt) in enumerate(checks):
            build.require(t, dt, f"pa_shape.arg{i}", dev)
        self.scratch = (torch.empty(self.rows * D, dtype=torch.int32, device=dev)
                        if self.scratch_route == "global" else None)
        p = build.ptr
        self.static = _Static(
            p(k), p(nperm), p(st.node_dom), p(fit.seed_flags), p(fit.seed_keys),
            p(fit.cap_flags), p(fit.cap_keys), p(self.scratch), self.rows, N, D,
            fit.seed_flags.shape[0], fit.cap_flags.shape[0],
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.fn = build.bind("pa_shape", "kat_pa_shape", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, row: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Shape the bound rows (``row`` None) or ``row`` i32[N] (a plan
        without bound rows) in place, and return them."""
        if (row is None) == (self.k is None):
            raise ValueError("pa_shape: pass a row exactly when the plan binds no rows")
        k = self.k if row is None else row
        if self.noop:
            return k
        if self.dev.type == "cpu":
            return k.copy_(pa_shape_plain(self.st, self.fit, k, self.nperm))
        if row is not None and self.first:  # the caller's rows keep their type all action
            build.require(row, torch.int32, "pa_shape.row", self.dev)
            if row.shape != (self.st.num_nodes,):
                raise ValueError(f"pa_shape: row shape {tuple(row.shape)}, "
                                 f"want ({self.st.num_nodes},)")
            self.first = False
        build.check(self.fn(self.static_ptr, build.ptr(row), 1, self.stream), "pa_shape")
        build.launched(pa_shape)
        return k


def pa_shape(st, fit, k: torch.Tensor, nperm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``k`` i32[rows, N] in packing order -> the shaped rows (a new
    tensor), through a plan of its own.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if k.dim() != 2 or k.dtype != torch.int32:
        raise TypeError("pa_shape: k must be i32[rows, N]")
    if k.device.type == "cpu":
        return pa_shape_plain(st, fit, k, nperm)
    return PaShapePlan(st, fit, k.clone(memory_format=torch.contiguous_format), nperm)()


pa_shape.launches = 0
