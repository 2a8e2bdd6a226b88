"""K2 ``lex_argmin``: masked lexicographic argmin over shared key columns,
one row per selected turn.

Replaces ops/common.py:lex_argmin (:49-66) as vmapped over a chunk's
queues by ops/allocate.py:select_turns (:505-550).  Keys f32[K, M] are
shared by every row; masks bool[S, M] select each row's candidates.
Returns (idx i32[S], any bool[S]): the first index of the
lexicographically smallest masked entry, 0 when nothing is masked.
CUDA source: csrc/lex_argmin.cu.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .build import I, P

BIG = 3.0e38  # rounds to the reference's float32 BIG

# C signature of csrc/lex_argmin.cu
SIGNATURES = {"kat_lex_argmin": (P, I, I, P, I, P, P, P, P)}


def lex_argmin_plain(keys: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's filter, key by key, batched over mask rows."""
    cand = mask.clone()
    for k in keys:
        kk = torch.where(cand, k[None, :], BIG)
        kmin = kk.amin(dim=-1, keepdim=True)
        cand = cand & (kk <= kmin)
    M = mask.shape[-1]
    pos = torch.arange(M, dtype=torch.int32, device=mask.device)
    first = torch.where(cand, pos[None, :], M).amin(dim=-1)
    idx = torch.where(first < M, first, 0).to(torch.int32)
    return idx, mask.any(dim=-1)


def lex_argmin(keys: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 keys [K, M], bool mask [S, M] -> (i32[S], bool[S]).  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if keys.dtype != torch.float32 or keys.dim() != 2:
        raise TypeError("lex_argmin: keys must be f32[K, M]")
    if mask.dtype != torch.bool or mask.dim() != 2 or mask.shape[1] != keys.shape[1]:
        raise ValueError("lex_argmin: mask must be bool[S, M] with keys' M")
    if keys.device.type == "cpu":
        return lex_argmin_plain(keys, mask)
    if keys.device.type != "cuda" or mask.device != keys.device:
        raise ValueError(f"lex_argmin: tensors on {keys.device} / {mask.device}")
    keys = keys.contiguous()
    mask = mask.contiguous()
    S, M = mask.shape
    cand = torch.empty((S, M), dtype=torch.uint8, device=keys.device)
    idx = torch.empty(S, dtype=torch.int32, device=keys.device)
    any_ = torch.empty(S, dtype=torch.bool, device=keys.device)
    fn = build.bind("lex_argmin", "kat_lex_argmin", SIGNATURES)
    build.check(fn(build.ptr(keys), keys.shape[0], M, build.ptr(mask), S,
                   build.ptr(cand), build.ptr(idx), build.ptr(any_),
                   build.stream()), "lex_argmin")
    lex_argmin.launches += 1
    return idx, any_


lex_argmin.launches = 0
