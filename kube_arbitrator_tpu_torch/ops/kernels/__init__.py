"""Hand-written CUDA kernels of the main path, each beside its plain
PyTorch version and with a launch counter:

* K1 :func:`admit_chunk.admit_chunk`         — ops/allocate.py slot body
* K2 :class:`lex_argmin.TurnPickPlan`        — a turn selection's job and group picks
* K3 :class:`decode_deferred.DecodePlan`     — deferred decode: counts -> placements
* K4 :func:`segment_sum.segment_sum`         — slot-order segment sums
* K5 :func:`seg_scan.seg_scan`               — ops/preempt victim-layout scans (SegScanPlan)
* K6 :class:`claim_nodes.ClaimNodesPlan`     — ops/preempt._apply_claim node half
* K7 :func:`canon_pick.canon_pick`           — reclaim turn: per-node sums, first fit (CanonPickPlan)
* K8 :func:`canon_commit.canon_commit`       — reclaim turn: window commit (CanonCommitPlan)
* K9 :func:`turn_caps.turn_caps`             — immediate turn: capacity, packing order
* K10 :func:`turn_fill.turn_fill`            — immediate turn: fill, writeback, decode (TurnFillPlan)
* K11 :func:`pa_fit.pa_fit`                  — pod-affinity fit of a turn's group
* K12 :func:`pa_shape.pa_shape`              — pod-affinity seed and domain cap (PaShapePlan)
* K13 :func:`round_products.round_products`  — opt-in reclaim: union eligibility, sums, scan
* K14 :func:`union_fit.union_fit`            — opt-in reclaim: own-queue subtraction, first fit (UnionFitPlan)
* K15 :func:`window_gate.window_gate`        — optimistic reclaim: the window's commit gate (WindowGatePlan)
* K16 :func:`stable_compact.stable_compact`  — commit lists, allocate's panel, preempt's panel
* K17 :func:`queue_order.queue_order`        — a round's queue order, keys built (QueueOrderPlan)
* K18 :class:`row_scatter.RowScatterPlan`   — an epoch's changed rows into the resident pack
* K19 :func:`stable_sort.stable_sort`        — victim lexsorts, K4's segment order, the claim join, searches
* K20 :func:`ordered_scan.ordered_scan`      — ops/common.mm_cumsum in XLA:CPU's order (OrderedScanPlan)

A wrapper takes the plain version only for CPU tensors; on CUDA tensors
it launches its kernel (built on first use, see build.py) or raises.
"""
from . import (
    admit_chunk, canon_commit, canon_pick, claim_nodes, decode_deferred, lex_argmin,
    ordered_scan, pa_fit, pa_shape, queue_order, round_products, row_scatter, seg_scan,
    segment_sum, stable_compact, stable_sort, turn_caps, turn_fill, union_fit, window_gate,
)

# kernel name -> wrapper or plan class (each carries its ``launches`` count)
KERNELS = {
    "admit_chunk": admit_chunk.admit_chunk,
    "lex_argmin": lex_argmin.TurnPickPlan,
    "decode_deferred": decode_deferred.DecodePlan,
    "segment_sum": segment_sum.segment_sum,
    "seg_scan": seg_scan.seg_scan,
    "claim_nodes": claim_nodes.ClaimNodesPlan,
    "canon_pick": canon_pick.canon_pick,
    "canon_commit": canon_commit.canon_commit,
    "turn_caps": turn_caps.turn_caps,
    "turn_fill": turn_fill.turn_fill,
    "pa_fit": pa_fit.pa_fit,
    "pa_shape": pa_shape.pa_shape,
    "round_products": round_products.round_products,
    "union_fit": union_fit.union_fit,
    "window_gate": window_gate.window_gate,
    "stable_compact": stable_compact.stable_compact,
    "queue_order": queue_order.queue_order,
    "row_scatter": row_scatter.RowScatterPlan,
    "stable_sort": stable_sort.stable_sort,
    "ordered_scan": ordered_scan.ordered_scan,
}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants = dict.fromkeys(fn.variants, 0)


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def variant_counts() -> dict:
    """Launches by variant of the kernels that have more than one (K1's
    panel / full width, one CTA / cluster; K5's scans and plan binds; K9's first fit, one-CTA and
    tiled sort, by call; K10's by_group / walk routes and its plans'
    index builds; K19's one-CTA / tiled sort, counting segment order, run
    starts and lookups)."""
    return {name: dict(fn.variants) for name, fn in KERNELS.items() if hasattr(fn, "variants")}
