"""K20 ``ordered_scan``: the inclusive f32 prefix sum along axis 0 of a
[V, C] array in XLA:CPU's add order, in one launch.

Replaces ``mm_cumsum`` (kube_arbitrator_tpu/ops/common.py:102-137; on the
CPU ``jnp.cumsum``, which XLA computes as a two-level scan of 16-wide
blocks): blocks of SCAN_BLOCK summed left to right, the blocks' totals
scanned by the same recursion, then each element plus its block's
exclusive offset; n <= SCAN_BLOCK is one left-to-right chain.  Plain f32
adds only, so the card gives the CPU's bits.  ``ops/common.mm_cumsum``
calls it.  CPU tensors take the plain version; CUDA tensors launch the
kernel.  CUDA source: csrc/ordered_scan.cu (one CTA per column).
"""
from __future__ import annotations

import torch

from . import build
from .build import I, P

SCAN_BLOCK = 16  # csrc/ordered_scan.cu's BLOCK
SMEM_LIMIT = 227 * 1024  # shared memory one CTA can have on an H100

# C signatures of csrc/ordered_scan.cu
SIGNATURES = {"kat_ordered_scan": (P, I, I, P, P)}


def ordered_scan_plain(v: torch.Tensor) -> torch.Tensor:
    """The same adds as elementwise torch ops, level by level."""
    n, c = v.shape
    B = SCAN_BLOCK
    if n == 0:
        return v
    if n <= B:
        cols = [v[0]]
        for i in range(1, n):
            cols.append(cols[-1] + v[i])
        return torch.stack(cols)
    nb = -(-n // B)
    vp = torch.cat([v, v.new_zeros((nb * B - n, c))]) if nb * B != n else v
    blocks = vp.reshape(nb, B, c)
    cols = [blocks[:, 0]]
    for i in range(1, B):
        cols.append(cols[-1] + blocks[:, i])
    inner = torch.stack(cols, dim=1)                           # [nb, B, c]
    outer = ordered_scan_plain(inner[:, -1].contiguous())      # inclusive over blocks
    excl = torch.cat([v.new_zeros((1, c)), outer[:-1]])
    return (inner + excl[:, None, :]).reshape(nb * B, c)[:n]


def smem_bytes(V: int) -> int:
    """Shared memory of the levels above level 0 (csrc's smem_bytes)."""
    total, n = 0, V
    while n > SCAN_BLOCK:
        n = -(-n // SCAN_BLOCK)
        total += n
    return 4 * total


def ordered_scan(v: torch.Tensor) -> torch.Tensor:
    """f32 [V, C] -> its inclusive prefix sum along axis 0, [V, C]."""
    if v.dtype != torch.float32 or v.dim() != 2:
        raise TypeError("ordered_scan: v must be f32[V, C]")
    if v.device.type == "cpu":
        return ordered_scan_plain(v)
    if v.device.type != "cuda":
        raise ValueError(f"ordered_scan: tensor on {v.device}")
    V, C = v.shape
    if smem_bytes(V) > SMEM_LIMIT:
        raise ValueError(f"ordered_scan: {V} rows need more shared memory than a CTA has")
    v = v.contiguous()
    out = torch.empty_like(v)
    if V == 0 or C == 0:
        return out
    fn = build.bind("ordered_scan", "kat_ordered_scan", SIGNATURES)
    build.check(fn(build.ptr(v), V, C, build.ptr(out), build.stream()), "ordered_scan")
    ordered_scan.launches += 1
    return out


ordered_scan.launches = 0
