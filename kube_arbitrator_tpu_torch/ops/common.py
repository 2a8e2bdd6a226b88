"""Shared kernel utilities: epsilon math and lexicographic selection
(the port of kube_arbitrator_tpu/ops/common.py).

In device units the epsilon slack is uniformly 10.0.  Every float
expression keeps the reference's operation order, and every f32 sum that
feeds a decision goes through K4 (``ordered_sum`` / ``segment_sum``) so
that it is added in one order on the CPU and on the card.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..api.resource import NUM_FAIR_RESOURCES
from ..cache.snapshot import DEVICE_EPSILON
from .kernels.lex_argmin import lex_argmin as _lex_argmin_k2
from .kernels.admit_chunk import to_i32
from .kernels.ordered_scan import ordered_scan
from .kernels.seg_scan import seg_scan
from .kernels.segment_sum import ordered_sum, segment_sum
from .kernels.stable_sort import stable_sort

EPS = DEVICE_EPSILON
BIG = 3.0e38  # rounds to the reference's float32 BIG (effectively +inf)
NUM_FAIR = NUM_FAIR_RESOURCES

__all__ = [
    "BIG", "EPS", "NUM_FAIR", "ceil_div_pos", "dominant_share", "fair", "fits",
    "lex_argmin", "lexsort", "mm_cumsum", "ordered_sum", "plugin_on", "safe_share",
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


def safe_share(alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """alloc/total with the zero-total convention (0, or 1 if alloc > 0)."""
    zero_total = torch.where(alloc > 0, 1.0, 0.0)
    return torch.where(total > 0, alloc / total.clamp(min=1e-30), zero_total)


def dominant_share(alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """max over FAIR resources of share(alloc_r, total_r)."""
    return safe_share(fair(alloc), fair(total)).amax(dim=-1)


def lex_argmin(keys: Sequence[torch.Tensor], mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index of the lexicographically smallest entry among ``mask``
    (ties -> first index; 0 when nothing is masked) and any(mask).
    ``keys`` are [M] columns shared by every row of ``mask`` ([M] or
    [S, M]); each is cast to f32 as the reference does.  Goes through K2."""
    k = torch.stack([c.to(torch.float32) for c in keys])
    if mask.dim() == 1:
        idx, any_ = _lex_argmin_k2(k, mask[None, :])
        return idx[0], any_[0]
    return _lex_argmin_k2(k, mask)


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
