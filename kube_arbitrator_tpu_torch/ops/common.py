"""Shared kernel utilities: epsilon math and lexicographic selection
(the port of kube_arbitrator_tpu/ops/common.py).

In device units the epsilon slack is uniformly 10.0.  Every float
expression keeps the reference's operation order, and every f32 sum that
feeds a decision goes through K4 (``ordered_sum`` / ``segment_sum``) so
that it is added in one order on the CPU and on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..api.resource import NUM_FAIR_RESOURCES
from ..cache.snapshot import DEVICE_EPSILON
from .kernels.admit_chunk import to_i32
from .kernels.ordered_scan import ordered_scan
from .kernels.seg_scan import seg_scan
from .kernels.segment_sum import ordered_sum, segment_sum
from .kernels.stable_sort import stable_sort

EPS = DEVICE_EPSILON
BIG = 3.0e38  # rounds to the reference's float32 BIG (effectively +inf)
NUM_FAIR = NUM_FAIR_RESOURCES

__all__ = [
    "BIG", "EPS", "FLT_MIN", "NUM_FAIR", "ceil_div_pos", "dominant_share", "fair", "fits", "ftz",
    "lexsort", "mm_cumsum", "ordered_sum", "plugin_on", "safe_share",
    "seg_cumsum", "segment_sum", "to_i32",
]


def fair(x: torch.Tensor) -> torch.Tensor:
    """The fairness view of a resource vector: cpu/memory/gpu only."""
    return x[..., :NUM_FAIR]


def fits(req: torch.Tensor, avail: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Epsilon-slacked LessEqual: all(req < avail + EPS) along ``dim``."""
    return (req < avail + EPS).all(dim=dim)


def is_empty_res(r: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return (r < EPS).all(dim=dim)


FLT_MIN = float(torch.finfo(torch.float32).tiny)  # the least normal f32


def ftz(x: torch.Tensor, also: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` with every subnormal f32 flushed to a zero of its sign, as
    XLA computes on the CPU and the TPU computes everywhere: a subnormal
    times 0 is a signed zero, every other value times 1 is itself (NaN,
    whose mask is False, stays NaN).  With ``also``, ``x`` is flushed
    where ``also`` (an operand of the op that made ``x``) is subnormal
    too, as if it had been read as a zero: one mask for both."""
    mag = x.abs() if also is None else torch.minimum(x.abs(), also.abs())
    return x * (mag >= FLT_MIN)


def safe_share(alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """alloc/total with the zero-total convention (0, or 1 if alloc > 0),
    flushed as the JAX package's share is: a subnormal ``alloc`` or
    ``total`` reads as a zero of its sign (a total is positive only from
    FLT_MIN up), and a quotient that comes out subnormal is a zero of its
    sign.  A zero of ``alloc``'s sign over a positive total is that zero,
    so flushing the quotient where ``alloc`` is subnormal is the same."""
    share = ftz(alloc / total.clamp(min=1e-30), also=alloc)
    return torch.where(total >= FLT_MIN, share, alloc >= FLT_MIN)


def dominant_share(alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """max over FAIR resources of share(alloc_r, total_r)."""
    return safe_share(fair(alloc), fair(total)).amax(dim=-1)


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """i64 permutation of ``jnp.lexsort(keys)`` (the LAST key primary,
    ties kept in index order) of one to six i32 keys, through K19."""
    return stable_sort(tuple(keys))[0].to(torch.int64)


def ceil_div_pos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ceil(a/b) for positive b, as int32, clipped at >= 0."""
    return to_i32(torch.ceil(a / b.clamp(min=1e-30)).clamp(min=0.0))


def seg_cumsum(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Segmented INCLUSIVE prefix sum along axis 0 of f32 ``x`` [V] or
    [V, C]; ``seg_start`` bool[V] marks each segment's first element.
    Through K5, serially within a segment in index order (the reference's
    native order; its jnp scan is a tree, equal at integer inputs)."""
    squeeze = x.dim() == 1
    v = (x[:, None] if squeeze else x).to(torch.float32).contiguous()
    ones = torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
    _, out = seg_scan(ones, None, seg_start, v)
    return out[:, 0] if squeeze else out


def mm_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along axis 0 of ``x`` [V] or [V, C], added
    in the order of the reference's ``mm_cumsum`` on the CPU
    (kube_arbitrator_tpu/ops/common.py:118-119: ``jnp.cumsum``, which XLA
    rewrites into a two-level scan): blocks of 16 summed left to right,
    plus the inclusive scan (the same recursion) of the previous blocks'
    totals.  Plain f32 adds only, so the card and the CPU give the
    reference's bits (``torch.cumsum`` would add in double on the CPU and
    in another order on the card).  Through K20."""
    squeeze = x.dim() == 1
    v = (x[:, None] if squeeze else x).to(torch.float32)
    out = ordered_scan(v)
    return out[:, 0] if squeeze else out


def plugin_on(tiers, name: str, attr: str) -> bool:
    """True when any tier enables plugin ``name`` (its ``attr`` disable
    flag unset)."""
    return any(
        p.name == name and not getattr(p, attr) for t in tiers for p in t.plugins
    )
