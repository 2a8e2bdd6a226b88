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
decided on the device.  CUDA source: csrc/round_products.cu.
"""
from __future__ import annotations

import torch

from . import build
from .build import I, P
from .canon_pick import canon_elig
from .seg_scan import seg_scan_plain
from .segment_sum import segment_sum_plain

# C signature of csrc/round_products.cu
SIGNATURES = {
    "kat_round_products": (
        P, P, P, P, P, P, P, P, P, I, I, I, I, P, P, P, I, I, P, P, P, P, P,
    ),
}


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


def round_products(st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
                   use_gang: bool, use_prop: bool, out, dirty=None):
    """Write the products of the current state into ``out`` (see the
    module docstring) and return it.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    args = (st, ctx, cand, rank_nj, cum_nq, job_ready_cnt, min_avail, queue_alloc,
            use_gang, use_prop, out, dirty)
    if cand.device.type == "cpu":
        return round_products_plain(*args)
    dev = cand.device
    if dev.type != "cuda":
        raise ValueError(f"round_products: tensors on {dev}")
    elig, pn, segcum = out
    checks = [
        (cand, torch.bool), (rank_nj, torch.float32), (cum_nq, torch.float32),
        (ctx.cj, torch.int32), (ctx.cq, torch.int32), (ctx.deserved_c, torch.float32),
        (job_ready_cnt, torch.int32), (min_avail, torch.int32), (queue_alloc, torch.float32),
        (st.rv_block_start, torch.int32), (st.rv_nq_start, torch.bool),
        (ctx.cres, torch.float32), (elig, torch.bool), (pn, torch.float32),
        (segcum, torch.float32),
    ] + ([(dirty, torch.bool)] if dirty is not None else [])
    for i, (t, dt) in enumerate(checks):
        build.require(t, dt, f"round_products.arg{i}", dev)
    Vp, R = ctx.cres.shape
    N = st.num_nodes
    if elig.shape != (Vp,) or pn.shape != (N, R + 1) or segcum.shape != (Vp, R + 1):
        raise ValueError("round_products: out must be (bool[Vp], f32[N, R+1], f32[Vp, R+1])")
    fn = build.bind("round_products", "kat_round_products", SIGNATURES)
    build.check(fn(
        build.ptr(cand), build.ptr(rank_nj), build.ptr(cum_nq), build.ptr(ctx.cj),
        build.ptr(ctx.cq), build.ptr(ctx.deserved_c), build.ptr(job_ready_cnt),
        build.ptr(min_avail), build.ptr(queue_alloc), R, cum_nq.shape[1], int(use_gang),
        int(use_prop), build.ptr(st.rv_block_start), build.ptr(st.rv_nq_start),
        build.ptr(ctx.cres), N, Vp, build.ptr(dirty), build.ptr(elig), build.ptr(pn),
        build.ptr(segcum), build.stream(),
    ), "round_products")
    round_products.launches += 1
    return out


round_products.launches = 0
