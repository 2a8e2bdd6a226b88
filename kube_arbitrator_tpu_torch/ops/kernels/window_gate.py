"""K15 ``window_gate``: the optimistic reclaim engine's commit gate over
one speculation window, in place.

Replaces the gate of the reference's ops/preempt.py:
_reclaim_canon_optimistic (:2735-2800).  ``pick`` i32[RP] is K14's
first feasible node per window row (N: the row does not claim; rows
outside the window were screened with ``pop`` cleared).  The gate
commits the burn / fail prefix before the first speculative claim
(``q_entries`` and ``job_consumed`` of its rows, ``progress``), counts
the speculative claims after the first as conflicts, advances the
window and ends the round, all on the device:

``ctl`` i32[CTL_LEN] carries START (the window's first position in the
round's queue order), TRIP (the round's turn count, written at round
start), and the counters ROUNDS, GATED (rounds finished in their first
window with no claim), CONFLICTS, ROUND_DONE (of the last window) and
WINDOWS.  The accepted row goes to ``sel`` = (i32[4] q, j, g, pick;
bool[4] has_grp, pop, burn_now, has_claim; f32[R] req) for K8, which
does nothing when has_claim is clear.  CUDA source: csrc/window_gate.cu.
"""
from __future__ import annotations

import torch

from . import build
from .build import I, P

START, TRIP, ROUNDS, GATED, CONFLICTS, ROUND_DONE, WINDOWS = range(7)
CTL_LEN = 8

# C signature of csrc/window_gate.cu
SIGNATURES = {
    "kat_window_gate": (P, I, I, P, P, P, P, P, I, P, P, P, P, P, P, P, P, P, P),
}


def new_gate(R: int, device) -> tuple:
    """(ctl, sel) buffers for :func:`window_gate`: counters at zero."""
    ctl = torch.zeros(CTL_LEN, dtype=torch.int32, device=device)
    sel = (torch.zeros(4, dtype=torch.int32, device=device),
           torch.zeros(4, dtype=torch.bool, device=device),
           torch.zeros(R, dtype=torch.float32, device=device))
    return ctl, sel


def window_gate_plain(pick, N, q_panel, jp, gp, hgp, reqp, popp, burnp, ctl, q_entries,
                      job_consumed, progress, sel):
    """The plain version, the reference's gate op for op."""
    RP = pick.shape[0]
    dev = pick.device
    i64 = torch.int64
    start, trip = int(ctl[START]), int(ctl[TRIP])
    w_iota = torch.arange(RP, device=dev)
    claimed_spec = pick < N
    has_claim = bool(claimed_spec.any())
    first = int(torch.nonzero(claimed_spec)[0, 0]) if has_claim else RP
    in_window = (start + w_iota) < trip
    commit = in_window & (w_iota < first)
    burn_or_fail = commit & (burnp | popp)
    q_entries.index_add_(0, q_panel[burn_or_fail].to(i64),
                         torch.full((int(burn_or_fail.sum()),), -1, dtype=q_entries.dtype,
                                    device=dev))
    job_consumed[jp[commit & popp].to(i64)] = True
    if bool((commit & popp).any()):
        progress.fill_(True)
    conflicts = int((claimed_spec & (w_iota > first)).sum())
    start_next = start + int(commit.sum()) + int(has_claim)
    round_done = start_next >= trip
    ctl[START] = 0 if round_done else start_next
    ctl[ROUNDS] += int(round_done)
    ctl[GATED] += int(round_done and start == 0 and not has_claim)
    ctl[CONFLICTS] += conflicts
    ctl[ROUND_DONE] = int(round_done)
    ctl[WINDOWS] += 1
    s = min(first, RP - 1)
    sel_i, sel_b, sel_req = sel
    sel_i.copy_(torch.stack([q_panel[s], jp[s], gp[s], pick[s]]).to(torch.int32))
    sel_b.copy_(torch.stack([hgp[s], popp[s], burnp[s],
                             torch.tensor(has_claim, device=dev)]))
    sel_req.copy_(reqp[s])
    return sel


def window_gate(pick, N: int, q_panel, jp, gp, hgp, reqp, popp, burnp, ctl, q_entries,
                job_consumed, progress, sel):
    """Gate one window in place (see the module docstring); returns
    ``sel``.  Rows: ``pick``/``q_panel``/``jp``/``gp`` i32[RP],
    ``hgp``/``popp``/``burnp`` bool[RP], ``reqp`` f32[RP, R].  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    args = (pick, N, q_panel, jp, gp, hgp, reqp, popp, burnp, ctl, q_entries, job_consumed,
            progress, sel)
    if pick.device.type == "cpu":
        return window_gate_plain(*args)
    dev = pick.device
    if dev.type != "cuda":
        raise ValueError(f"window_gate: tensors on {dev}")
    sel_i, sel_b, sel_req = sel
    checks = [
        (pick, torch.int32), (q_panel, torch.int32), (jp, torch.int32), (gp, torch.int32),
        (hgp, torch.bool), (reqp, torch.float32), (popp, torch.bool), (burnp, torch.bool),
        (ctl, torch.int32), (q_entries, torch.int32), (job_consumed, torch.bool),
        (progress, torch.bool), (sel_i, torch.int32), (sel_b, torch.bool),
        (sel_req, torch.float32),
    ]
    for i, (t, dt) in enumerate(checks):
        build.require(t, dt, f"window_gate.arg{i}", dev)
    RP, R = reqp.shape
    if RP == 0 or ctl.shape != (CTL_LEN,) or sel_req.shape != (R,):
        raise ValueError("window_gate: empty panel or mis-shaped ctl / sel")
    fn = build.bind("window_gate", "kat_window_gate", SIGNATURES)
    build.check(fn(
        build.ptr(pick), N, RP, build.ptr(q_panel), build.ptr(jp), build.ptr(gp),
        build.ptr(hgp), build.ptr(reqp), R, build.ptr(popp), build.ptr(burnp), build.ptr(ctl),
        build.ptr(q_entries), build.ptr(job_consumed), build.ptr(progress), build.ptr(sel_i),
        build.ptr(sel_b), build.ptr(sel_req), build.stream(),
    ), "window_gate")
    window_gate.launches += 1
    return sel


window_gate.launches = 0
