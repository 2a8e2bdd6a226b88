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
window with no claim), CONFLICTS, ROUND_DONE (of the last window),
WINDOWS and PROGRESS (the round's progress after the window's prefix;
K8 sets it too where it sets ``progress``, through its
``progress_out``).  csrc/common.cuh's ``KAT_CTL_*`` is the same layout.
The accepted row goes to ``sel`` = (i32[4] q, j, g, pick; bool[4]
has_grp, pop, burn_now, has_claim; f32[R] req) for K8, which does
nothing when has_claim is clear.

:class:`WindowGatePlan` binds one optimistic engine call's launches
once (a launch passes only ``q_panel``, ``reqp`` and the round's
``progress``); :func:`window_gate` is the same through a throwaway
plan.  CUDA source: csrc/window_gate.cu.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .build import P
from .canon_pick import WIDE

START, TRIP, ROUNDS, GATED, CONFLICTS, ROUND_DONE, WINDOWS, PROGRESS = range(8)
CTL_LEN = 8

# C signature of csrc/window_gate.cu: (static, call, stream)
SIGNATURES = {"kat_window_gate": (P, P, P)}


class _Static(ctypes.Structure):
    """csrc/window_gate.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "pick", "jp", "gp", "hgp", "popp", "burnp", "ctl", "q_entries", "job_consumed", "sel_i",
        "sel_b", "sel_req",
    )] + [(n, ctypes.c_int) for n in ("N", "RP", "R")]


class _Call(ctypes.Structure):
    """csrc/window_gate.cu's Call: a launch's own arguments, set in place."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("q_panel", "reqp", "progress")] + [
        ("q_wide", ctypes.c_int)]


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
    s = min(first, RP - 1)
    ctl[START] = 0 if round_done else start_next
    ctl[ROUNDS] += int(round_done)
    ctl[GATED] += int(round_done and start == 0 and not has_claim)
    ctl[CONFLICTS] += conflicts
    ctl[ROUND_DONE] = int(round_done)
    ctl[WINDOWS] += 1
    ctl[PROGRESS] = int(bool(progress))
    sel_i, sel_b, sel_req = sel
    sel_i.copy_(torch.stack([q_panel[s].to(torch.int32), jp[s], gp[s], pick[s]]))
    sel_b.copy_(torch.stack([hgp[s], popp[s], burnp[s],
                             torch.tensor(has_claim, device=dev)]))
    sel_req.copy_(reqp[s])
    return sel


class WindowGatePlan:
    """K15's launches over one ``_reclaim_canon_optimistic`` call.

    Built once per call: it checks the dtypes and shapes once and binds
    K14's plan-owned ``pick``, K2's plan-owned pop rows ``jp`` / ``gp`` /
    ``hgp`` / ``popp`` / ``burnp``, the carry's ``q_entries`` and
    ``job_consumed``, and ``ctl`` / ``sel`` (the plan's own
    :func:`new_gate` buffers unless given), and keeps the stream current
    when it was built.  Every bound tensor must be updated IN PLACE
    between launches (K2 and K14 overwrite their rows, K8 the carry).  A
    launch passes ``q_panel`` (i32 or i64 [RP]), ``reqp`` f32[RP, R] and
    the round's ``progress``: each can be a new tensor every window or
    round.  ``ctl`` and ``sel`` are written by every launch: K8 consumes
    ``sel`` before the next, the engine reads ``ctl`` once a window.  CPU
    tensors take the plain version on the same buffers."""

    def __init__(self, pick, N: int, jp, gp, hgp, popp, burnp, q_entries, job_consumed, R: int,
                 ctl=None, sel=None):
        dev = pick.device
        self.dev = dev
        if ctl is None:
            ctl, sel = new_gate(R, dev)
        self.ctl, self.sel = ctl, sel
        self.N = N
        self.rows = (pick, jp, gp, hgp, popp, burnp)
        self.carry = (q_entries, job_consumed)
        self.first = True
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"window_gate: tensors on {dev}")
        RP = pick.shape[0]
        sel_i, sel_b, sel_req = sel
        checks = [
            (pick, torch.int32, (RP,)), (jp, torch.int32, (RP,)), (gp, torch.int32, (RP,)),
            (hgp, torch.bool, (RP,)), (popp, torch.bool, (RP,)), (burnp, torch.bool, (RP,)),
            (ctl, torch.int32, (CTL_LEN,)), (q_entries, torch.int32, None),
            (job_consumed, torch.bool, None), (sel_i, torch.int32, (4,)),
            (sel_b, torch.bool, (4,)), (sel_req, torch.float32, (R,)),
        ]
        for i, (t, dt, shape) in enumerate(checks):
            build.require(t, dt, f"window_gate.arg{i}", dev)
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"window_gate.arg{i}: shape {tuple(t.shape)}, want {shape}")
        if RP == 0:
            raise ValueError("window_gate: empty panel")
        p = build.ptr
        self.static = _Static(p(pick), p(jp), p(gp), p(hgp), p(popp), p(burnp), p(ctl),
                              p(q_entries), p(job_consumed), p(sel_i), p(sel_b), p(sel_req),
                              N, RP, R)
        self.static_ptr = ctypes.addressof(self.static)
        self.call = _Call()
        self.call_ptr = ctypes.addressof(self.call)
        self.fn = build.bind("window_gate", "kat_window_gate", SIGNATURES)
        self.stream = build.stream()

    def __call__(self, q_panel: torch.Tensor, reqp: torch.Tensor, progress: torch.Tensor):
        """Gate one window in place; returns ``sel``."""
        if self.dev.type == "cpu":
            pick, jp, gp, hgp, popp, burnp = self.rows
            return window_gate_plain(pick, self.N, q_panel, jp, gp, hgp, reqp, popp, burnp,
                                     self.ctl, *self.carry, progress, self.sel)
        c = self.call
        c.q_wide = WIDE.get(q_panel.dtype, -1)
        if c.q_wide < 0:
            raise TypeError(f"window_gate: q_panel dtype {q_panel.dtype}, want i32 or i64")
        if self.first:  # the launch's tensors keep their types all engine call
            RP, R = self.rows[0].shape[0], self.sel[2].shape[0]
            build.require(q_panel, q_panel.dtype, "window_gate.q_panel", self.dev)
            build.require(reqp, torch.float32, "window_gate.reqp", self.dev)
            build.require(progress, torch.bool, "window_gate.progress", self.dev)
            if q_panel.shape != (RP,) or reqp.shape != (RP, R) or progress.numel() != 1:
                raise ValueError(f"window_gate: q_panel must be [{RP}], reqp [{RP}, {R}], "
                                 "progress one flag")
            self.first = False
        c.q_panel, c.reqp, c.progress = q_panel.data_ptr(), reqp.data_ptr(), progress.data_ptr()
        build.check(self.fn(self.static_ptr, self.call_ptr, self.stream), "window_gate")
        build.launched(window_gate)
        return self.sel


def window_gate(pick, N: int, q_panel, jp, gp, hgp, reqp, popp, burnp, ctl, q_entries,
                job_consumed, progress, sel):
    """Gate one window in place (see the module docstring); returns
    ``sel``.  Rows: ``pick``/``jp``/``gp`` i32[RP], ``q_panel`` i32 or
    i64 [RP], ``hgp``/``popp``/``burnp`` bool[RP], ``reqp`` f32[RP, R].
    CPU tensors take the plain version; CUDA tensors launch the kernel
    once through a plan of its own."""
    if pick.device.type == "cpu":
        return window_gate_plain(pick, N, q_panel, jp, gp, hgp, reqp, popp, burnp, ctl,
                                 q_entries, job_consumed, progress, sel)
    return WindowGatePlan(pick, N, jp, gp, hgp, popp, burnp, q_entries, job_consumed,
                          sel[2].shape[0], ctl, sel)(q_panel, reqp, progress)


window_gate.launches = 0
