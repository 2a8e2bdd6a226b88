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
from .kernels.segment_sum import ordered_sum, segment_sum

EPS = DEVICE_EPSILON
BIG = 3.0e38  # rounds to the reference's float32 BIG (effectively +inf)
NUM_FAIR = NUM_FAIR_RESOURCES

__all__ = [
    "BIG", "EPS", "NUM_FAIR", "ceil_div_pos", "dominant_share", "fair", "fits",
    "lex_argmin", "mm_cumsum", "ordered_sum", "plugin_on", "safe_share",
    "segment_sum", "to_i32",
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


def ceil_div_pos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ceil(a/b) for positive b, as int32, clipped at >= 0."""
    return to_i32(torch.ceil(a / b.clamp(min=1e-30)).clamp(min=0.0))


def mm_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0.  The reference's triangular-matmul
    form is a TPU device choice; off the TPU it is a plain cumsum
    (kube_arbitrator_tpu/ops/common.py:118-119)."""
    return torch.cumsum(x, dim=0)


def plugin_on(tiers, name: str, attr: str) -> bool:
    """True when any tier enables plugin ``name`` (its ``attr`` disable
    flag unset)."""
    return any(
        p.name == name and not getattr(p, attr) for t in tiers for p in t.plugins
    )
