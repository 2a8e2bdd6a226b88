"""K13 ``round_products``: the union eligibility, per-node victim sums and
(node, queue) segmented scan that the opt-in reclaim engines read at a
round or a speculation window.

Replaces the reference's ops/preempt.py:_round_products (:2582-2606),
which both ``_reclaim_canon_batched`` and ``_reclaim_canon_optimistic``
call.  From the carried canon state it writes, into ``out`` = (elig
bool[Vp], pn f32[N, R+1], segcum f32[Vp, R+1]):

* ``elig``: ``_canon_elig`` (K7's and K8's definition, csrc/canon.cuh);
* ``pn``: the per-node ``[count | resreq]`` sums of the eligible slots,
  in slot order from zero;
* ``segcum``: the inclusive scan of the same rows within the (node,
  queue) segments of ``rv_nq_start``, serially in slot order (K5's
  order; the reference's tree scan gives the same bits at integer
  inputs below 2^24).

``dirty`` (optional bool[1] on the device): when clear, nothing is
written — the batched engine's refresh at the first turn after a claim,
decided on the device.  :class:`RoundProductsPlan` binds an engine
call's launches once (the carried state is updated in place between
them, so a launch passes only ``dirty``); :func:`round_products` is the
same through a throwaway plan.  CUDA source: csrc/round_products.cu.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .build import P
from .canon_pick import canon_elig
from .seg_scan import seg_scan_plain
from .segment_sum import segment_sum_plain

# C signature of csrc/round_products.cu: (static, dirty, stream)
SIGNATURES = {"kat_round_products": (P, P, P)}


class _Static(ctypes.Structure):
    """csrc/round_products.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "cand", "rank_nj", "cum_nq", "cj", "cq", "deserved_c", "job_ready_cnt", "min_avail",
        "queue_alloc", "bstart", "nq_start", "cres", "elig", "pn", "segcum",
    )] + [(n, ctypes.c_int) for n in ("R", "F", "use_gang", "use_prop", "N", "Vp")]


def new_products(Vp: int, N: int, R: int, device) -> tuple:
    """Empty (elig, pn, segcum) buffers for :func:`round_products`."""
    return (torch.zeros(Vp, dtype=torch.bool, device=device),
            torch.zeros((N, R + 1), dtype=torch.float32, device=device),
            torch.zeros((Vp, R + 1), dtype=torch.float32, device=device))


def round_products_plain(st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
                         use_gang, use_prop, out, dirty=None):
    """The plain version.  The padding past the last node block is a
    segment of its own with no eligible slot, so its scan is zeros."""
    if dirty is not None and not bool(dirty.reshape(())):
        return out
    elig_o, pn_o, seg_o = out
    N = st.num_nodes
    elig = canon_elig(ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
                      use_gang, use_prop)
    stat = torch.cat([elig.to(torch.float32)[:, None],
                      torch.where(elig[:, None], ctx.cres, 0.0)], dim=1)
    V = int(st.rv_block_start[-1])
    seg = torch.zeros_like(stat)
    if V > 0:
        _, seg[:V] = seg_scan_plain(torch.ones(V, dtype=torch.bool, device=stat.device), None,
                                    st.rv_nq_start[:V], stat[:V].contiguous())
    elig_o.copy_(elig)
    pn_o.copy_(segment_sum_plain(stat, ctx.cnode, N, order=ctx.cnode_order))
    seg_o.copy_(seg)
    return out


class RoundProductsPlan:
    """K13's launches over one engine call on the carried canon state.

    Built once per ``_reclaim_canon_batched`` / ``_reclaim_canon_optimistic``
    call: it checks the dtypes and shapes once, binds the fixed pointers
    (the canon context, the pack's block starts and segment flags, the
    carry's ``cand`` / ``rank_nj`` / ``cum_nq``, ``job_ready_cnt``,
    ``min_avail``, ``queue_alloc`` and the three outputs) and keeps the
    stream current when it was built.  Every bound tensor must be updated
    IN PLACE between launches (K8 writes the carry, ``job_ready_cnt`` and
    ``queue_alloc`` in place; the canon engines never reassign them): a
    launch reads whatever they hold then.  ``out`` defaults to fresh
    :func:`new_products` buffers (``self.out``).  CPU tensors take the
    plain version."""

    def __init__(self, st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
                 use_gang: bool, use_prop: bool, out=None):
        self.args = (st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
                     bool(use_gang), bool(use_prop))
        dev = cand.device
        Vp, R = ctx.cres.shape
        N = st.num_nodes
        self.out = new_products(Vp, N, R, dev) if out is None else out
        self.dev = dev
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"round_products: tensors on {dev}")
        elig, pn, segcum = self.out
        F = cum_nq.shape[1]
        checks = [
            (cand, torch.bool, (Vp,)), (rank_nj, torch.float32, (Vp,)),
            (cum_nq, torch.float32, (Vp, F)), (ctx.cj, torch.int32, (Vp,)),
            (ctx.cq, torch.int32, (Vp,)), (ctx.deserved_c, torch.float32, (Vp, F)),
            (job_ready_cnt, torch.int32, None), (min_avail, torch.int32, None),
            (queue_alloc, torch.float32, None), (st.rv_block_start, torch.int32, (N + 1,)),
            (st.rv_nq_start, torch.bool, (Vp,)), (ctx.cres, torch.float32, (Vp, R)),
            (elig, torch.bool, (Vp,)), (pn, torch.float32, (N, R + 1)),
            (segcum, torch.float32, (Vp, R + 1)),
        ]
        for i, (t, dt, shape) in enumerate(checks):
            build.require(t, dt, f"round_products.arg{i}", dev)
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"round_products.arg{i}: shape {tuple(t.shape)}, want {shape}")
        if queue_alloc.dim() != 2 or queue_alloc.shape[1] != R:
            raise ValueError("round_products: queue_alloc must be f32[Q, R]")
        if R + 1 > 32:
            raise ValueError(f"round_products: R + 1 = {R + 1} columns, a warp holds 32")
        p = build.ptr
        self.static = _Static(
            p(cand), p(rank_nj), p(cum_nq), p(ctx.cj), p(ctx.cq), p(ctx.deserved_c),
            p(job_ready_cnt), p(min_avail), p(queue_alloc), p(st.rv_block_start),
            p(st.rv_nq_start), p(ctx.cres), p(elig), p(pn), p(segcum),
            R, F, int(use_gang), int(use_prop), N, Vp,
        )
        self.static_ptr = ctypes.addressof(self.static)
        self.fn = build.bind("round_products", "kat_round_products", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, dirty=None):
        """Write the products of the bound state into ``self.out`` (only
        where ``dirty``, bool[1] on the plan's device, is set) and return
        it."""
        if self.dev.type == "cpu":
            return round_products_plain(*self.args, self.out, dirty)
        if dirty is not None and (dirty.dtype != torch.bool or dirty.device != self.dev):
            raise ValueError("round_products: dirty must be bool[1] on the plan's device")
        build.check(self.fn(self.static_ptr, build.ptr(dirty), self.stream), "round_products")
        build.launched(round_products)
        return self.out


def round_products(st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
                   use_gang: bool, use_prop: bool, out, dirty=None):
    """Write the products of the current state into ``out`` (see the
    module docstring) and return it, through a plan of its own.  CPU
    tensors take the plain version; CUDA tensors launch the kernel once."""
    if cand.device.type == "cpu":
        return round_products_plain(st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail,
                                    queue_alloc, use_gang, use_prop, out, dirty)
    return RoundProductsPlan(st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail,
                             queue_alloc, use_gang, use_prop, out)(dirty)


round_products.launches = 0
