"""K12 ``pa_shape``: the pod-affinity shaping of one turn's capacity.

Replaces ops/podaffinity.py:apply_seed (:173-193) and apply_domain_cap
(:196-227) of the reference, folded in order, seed terms first: a seed
term keeps only the first domain (of its key) with the largest capacity
sum; a cap term keeps, per domain, the first position in packing order
with capacity > 0, at one copy.  Rows are per-node capacities in packing
order (``nperm``: node at each position, or None for node order): the
immediate allocate turn shapes its idle and releasing rows in one call,
preempt's claim its claim capacity between K6's two launches.
CUDA source: csrc/pa_shape.cu.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .build import I, P

# C signature of csrc/pa_shape.cu
SIGNATURES = {"kat_pa_shape": (P, P, I, I, P, P, I, P, P, I, P, P, I, P, P)}


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


def pa_shape(st, fit, k: torch.Tensor, nperm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``k`` i32[rows, N] in packing order -> the shaped rows (a new
    tensor).  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if k.dim() != 2 or k.dtype != torch.int32:
        raise TypeError("pa_shape: k must be i32[rows, N]")
    if k.device.type == "cpu":
        return pa_shape_plain(st, fit, k, nperm)
    dev = k.device
    if dev.type != "cuda":
        raise ValueError(f"pa_shape: tensors on {dev}")
    rows, N = k.shape
    if N != st.num_nodes or (nperm is not None and nperm.shape != (N,)):
        raise ValueError("pa_shape: node axes disagree")
    k = k.contiguous()
    for i, (t, dt) in enumerate([
        (st.node_dom, torch.int32), (fit.seed_flags, torch.bool), (fit.seed_keys, torch.int32),
        (fit.cap_flags, torch.bool), (fit.cap_keys, torch.int32),
    ] + ([(nperm, torch.int32)] if nperm is not None else [])):
        build.require(t, dt, f"pa_shape.arg{i}", dev)
    if st.node_dom.shape[0] == 0:
        return k
    D = st.num_domains
    out = torch.empty_like(k)
    scratch = torch.empty(D, dtype=torch.int32, device=dev)
    fn = build.bind("pa_shape", "kat_pa_shape", SIGNATURES)
    p = build.ptr
    build.check(fn(
        p(k), p(out), rows, N, p(nperm), p(st.node_dom), D, p(fit.seed_flags),
        p(fit.seed_keys), fit.seed_flags.shape[0], p(fit.cap_flags), p(fit.cap_keys),
        fit.cap_flags.shape[0], p(scratch), build.stream(),
    ), "pa_shape")
    pa_shape.launches += 1
    return out


pa_shape.launches = 0
