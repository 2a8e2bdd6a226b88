"""K2 the turn pick: a turn selection's job pick and group pick.

Replaces the reference's ``lex_argmin`` (ops/common.py:49-66) as
``_select_turn`` / ``select_turns`` (ops/allocate.py:505-550) apply it
twice a turn — the job pick over the queue's jobs, then the group pick
within the job — and as the reclaim pops (ops/preempt.py:1980-2010) do,
with the OverusedFn row filter.  :class:`TurnPickPlan` binds an action's
launches once: a call builds each slot row's job mask, runs the job
argmin, builds the group mask and runs the group argmin, one launch for
the whole selection.  :func:`lex_argmin_plain` is the reference's filter
and :func:`turn_pick_plain` the selection around it, as the callers ran
it before the kernel built the masks and keys.  CUDA source:
csrc/lex_argmin.cu.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...api.resource import NUM_FAIR_RESOURCES
from ...cache.snapshot import DEVICE_EPSILON
from ..ordering import group_order_key_spec, job_order_key_spec, job_order_keys
from . import build
from .build import P

BIG = 3.0e38  # rounds to the reference's float32 BIG
EPS = DEVICE_EPSILON
MAX_KEYS = 8  # key columns a pick filters on (csrc/lex_argmin.cu)
SMEM_MAX = 200 * 1024  # dynamic shared memory a CTA may take (csrc/lex_argmin.cu)
# a job key column's kind (csrc/lex_argmin.cu's KIND_*) and static row
KINDS = {"neg_priority": (0, True), "ready": (1, False), "not_ready_rank": (2, True),
         "share": (3, False), "rank": (0, True)}

# C signature of csrc/lex_argmin.cu: (static, call, stream)
SIGNATURES = {"kat_turn_pick": (P, P, P)}


class _Static(ctypes.Structure):
    """csrc/lex_argmin.cu's Static: the fixed arguments of a plan."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "job_queue", "job_valid", "group_job", "job_rows", "group_rows", "queue_valid",
        "deserved")] + [(n, ctypes.c_int) for n in (
            "J", "G", "KJ", "KG", "NR", "R", "F", "staged", "smem")] + [
        ("job_kind", ctypes.c_int * MAX_KEYS), ("job_row", ctypes.c_int * MAX_KEYS)]


class _Call(ctypes.Structure):
    """csrc/lex_argmin.cu's Call: a launch's own arguments."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q", "ok", "q_entry", "queue_alloc", "job_has_pending", "job_ready", "job_share",
        "grp_elig", "j_out", "has_job_out", "g_out", "has_grp_out", "jmask_out", "pop_out",
        "burn_out")] + [(n, ctypes.c_int) for n in ("S", "q_wide", "idx_wide", "pop_mode")]


def lex_argmin_plain(keys: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's filter, key by key, batched over the rows of
    ``mask`` bool[S, M] with the key columns f32[K, M]: (first surviving
    index i32[S], 0 when none; any(mask) bool[S]).  ``amin`` keeps a NaN,
    as ``jnp.min`` does, so a NaN candidate leaves no survivor."""
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


def q_over_plain(q, queue_alloc, deserved) -> torch.Tensor:
    """bool[S]: proportion's OverusedFn of the rows' queues."""
    F = NUM_FAIR_RESOURCES
    return (deserved[q][:, :F] < queue_alloc[q][:, :F] + EPS).all(dim=-1)


def turn_pick_plain(job_queue, job_valid, group_job, jkeys, gkeys, q, ok, job_has_pending,
                    grp_elig):
    """One selection as the callers built it around two argmins: (j i32[S],
    has_job, g i32[S], has_grp, jmask bool[S, J])."""
    jmask = ((job_queue[None, :] == q[:, None]) & (job_has_pending & job_valid)[None, :]
             & ok[:, None])
    j, has_job = lex_argmin_plain(jkeys, jmask)
    gmask = (group_job[None, :] == j[:, None].to(group_job.dtype)) & grp_elig[None, :] \
        & has_job[:, None]
    g, has_grp = lex_argmin_plain(gkeys, gmask)
    return j, has_job, g, has_grp, jmask


class TurnPickPlan:
    """K2's launches over one action for ``tiers``: the pack's
    ``job_queue``, ``job_valid``, ``group_job`` and the static key rows
    (-priority, creation rank + 1 and creation rank of the jobs,
    ``ordering.job_order_key_spec``; the groups' ``group_order_keys``),
    cast once here; with ``deserved`` f32[Q, R] (the session's), the pop
    rows' OverusedFn too.

    :meth:`select` serves ``select_turns`` and :meth:`pop` the reclaim
    pops; each is one launch with no torch op around it.  The outputs
    are the plan's own tensors, one set per (rows, form), OVERWRITTEN by
    the next call of the same form and row count: a selection consumes
    them before the next one (a caller that keeps one selection past the
    next of its shape uses a second plan).  CPU tensors take the plain
    version, into the same owned outputs.  ``launches`` counts the
    kernel's launches over every plan."""

    launches = 0

    def __init__(self, st, tiers, deserved: Optional[torch.Tensor] = None):
        dev = st.job_queue.device
        self.dev, self.st, self.tiers, self.deserved = dev, st, tiers, deserved
        f32 = torch.float32
        J, G = st.job_queue.shape[0], st.group_job.shape[0]
        jspec, gspec = job_order_key_spec(tiers), group_order_key_spec(tiers)
        if len(jspec) > MAX_KEYS or len(gspec) > MAX_KEYS:
            raise ValueError(f"turn_pick: {len(jspec)} job / {len(gspec)} group keys, "
                             f"at most {MAX_KEYS}")
        self.gkeys = torch.stack([-st.group_priority.to(f32) if k == "neg_priority"
                                  else st.group_uid_rank.to(f32) for k in gspec]).contiguous()
        self.outs = {}
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"turn_pick: tensors on {dev}")
        rank = st.job_creation_rank.to(f32)
        rows = {"neg_priority": -st.job_priority.to(f32), "not_ready_rank": rank + 1.0,
                "rank": rank}
        names = [k for k in dict.fromkeys(jspec) if KINDS[k][1]]
        self.job_rows = (torch.stack([rows[k] for k in names]) if names
                         else torch.zeros((1, J), dtype=f32, device=dev)).contiguous()
        for t, dt, name in ((st.job_queue, torch.int32, "job_queue"),
                            (st.job_valid, torch.bool, "job_valid"),
                            (st.group_job, torch.int32, "group_job")):
            build.require(t, dt, f"turn_pick.{name}", dev)
        R = F = 0
        if deserved is not None:
            build.require(deserved, f32, "turn_pick.deserved", dev)
            build.require(st.queue_valid, torch.bool, "turn_pick.queue_valid", dev)
            R, F = deserved.shape[1], NUM_FAIR_RESOURCES
        KJ, KG = len(jspec), len(gspec)
        # staged: the job and group keys, group_job and grp_elig, then the candidates
        staged_bytes = (KJ * J + KG * G) * 4 + G * 5 + max(J, G)
        staged = staged_bytes <= SMEM_MAX
        smem = staged_bytes if staged else max(J, G)
        if smem > SMEM_MAX:
            raise ValueError(f"turn_pick: J = {J}, G = {G}: {smem} B of candidates, "
                             f"at most {SMEM_MAX}")
        p = build.ptr
        kinds = (ctypes.c_int * MAX_KEYS)(*[KINDS[k][0] for k in jspec])
        row_of = (ctypes.c_int * MAX_KEYS)(*[names.index(k) if KINDS[k][1] else 0 for k in jspec])
        self.static = _Static(p(st.job_queue), p(st.job_valid), p(st.group_job), p(self.job_rows),
                              p(self.gkeys), p(st.queue_valid) if deserved is not None else 0,
                              p(deserved), J, G, KJ, KG, self.job_rows.shape[0], R, F, int(staged),
                              smem, kinds, row_of)
        self.static_ptr = ctypes.addressof(self.static)
        self.needs = {k for k in jspec if not KINDS[k][1]}  # per-call columns
        self.fn = build.bind("lex_argmin", "kat_turn_pick", SIGNATURES)
        self.stream = build.stream()

    def _outputs(self, S: int, form: str, jmask: bool):
        """The owned outputs of ``form`` ("select": i64 indices, the job
        mask; "pop": i32 indices, pop and burn) at ``S`` rows."""
        key = (S, form, jmask)
        out = self.outs.get(key)
        if out is None:
            idx = torch.int64 if form == "select" else torch.int32
            J = self.st.job_queue.shape[0]

            def new(dtype, *shape):
                return torch.empty(shape or (S,), dtype=dtype, device=self.dev)

            b, pops = torch.bool, form == "pop"
            out = dict(j=new(idx), has_job=new(b), g=new(idx), has_grp=new(b),
                       jmask=new(b, S, J) if jmask else None,
                       pop=new(b) if pops else None, burn=new(b) if pops else None)
            if self.dev.type == "cuda":
                p = build.ptr
                call = _Call(j_out=p(out["j"]), has_job_out=p(out["has_job"]), g_out=p(out["g"]),
                             has_grp_out=p(out["has_grp"]), jmask_out=p(out["jmask"]),
                             pop_out=p(out["pop"]), burn_out=p(out["burn"]), S=S,
                             idx_wide=int(form == "select"), pop_mode=int(form == "pop"))
                out["call"], out["call_ptr"] = call, ctypes.addressof(call)
                out["checked"] = False
            self.outs[key] = out
        return out

    def _plain(self, q, ok, job_has_pending, job_ready, job_share, grp_elig, out):
        st = self.st
        jkeys = torch.stack(job_order_keys(self.tiers, st.job_priority, job_ready,
                                           st.job_creation_rank, job_share))
        j, has_job, g, has_grp, jmask = turn_pick_plain(
            st.job_queue, st.job_valid, st.group_job, jkeys, self.gkeys, q, ok, job_has_pending,
            grp_elig)
        for name, v in (("j", j), ("has_job", has_job), ("g", g), ("has_grp", has_grp),
                        ("jmask", jmask)):
            if out[name] is not None:
                out[name].copy_(v)

    def _launch(self, out, q, ok, q_entry, queue_alloc, job_has_pending, job_ready, job_share,
                grp_elig):
        c = out["call"]
        if not out["checked"]:
            self._check(out, q, ok, q_entry, queue_alloc, job_has_pending, job_ready, job_share,
                        grp_elig)
        c.q, c.ok, c.q_entry = q.data_ptr(), build.ptr(ok), build.ptr(q_entry)
        c.queue_alloc, c.job_has_pending = build.ptr(queue_alloc), job_has_pending.data_ptr()
        c.job_ready = job_ready.data_ptr() if "ready" in self.needs or \
            "not_ready_rank" in self.needs else 0
        c.job_share = job_share.data_ptr() if "share" in self.needs else 0
        c.grp_elig, c.q_wide = grp_elig.data_ptr(), int(q.dtype == torch.int64)
        build.check(self.fn(self.static_ptr, out["call_ptr"], self.stream), "turn_pick")
        build.launched(TurnPickPlan)

    def _check(self, out, q, ok, q_entry, queue_alloc, job_has_pending, job_ready, job_share,
               grp_elig):
        """The first launch of an output set checks its arguments' types
        and shapes (they hold for the action)."""
        S, J, G = out["j"].shape[0], self.st.job_queue.shape[0], self.st.group_job.shape[0]
        dev = self.dev
        if q.dtype not in (torch.int32, torch.int64) or q.shape != (S,) or not q.is_contiguous():
            raise TypeError("turn_pick: q must be contiguous i32 / i64 [S]")
        args = [(job_has_pending, torch.bool, (J,), "job_has_pending"),
                (grp_elig, torch.bool, (G,), "grp_elig")]
        if ok is not None:
            args.append((ok, torch.bool, (S,), "ok"))
        if q_entry is not None:
            args += [(q_entry, torch.int32, (S,), "q_entry"),
                     (queue_alloc, torch.float32, tuple(self.deserved.shape), "queue_alloc")]
        if "ready" in self.needs or "not_ready_rank" in self.needs:
            args.append((job_ready, torch.bool, (J,), "job_ready"))
        if "share" in self.needs:
            args.append((job_share, torch.float32, (J,), "job_share"))
        for t, dt, shape, name in args:
            build.require(t, dt, f"turn_pick.{name}", dev)
            if tuple(t.shape) != shape:
                raise ValueError(f"turn_pick.{name}: shape {tuple(t.shape)}, want {shape}")
        build.require(q, q.dtype, "turn_pick.q", dev)
        out["checked"] = True

    def select(self, q: torch.Tensor, ok: torch.Tensor, job_has_pending: torch.Tensor,
               job_ready: torch.Tensor, job_share: torch.Tensor, grp_elig: torch.Tensor,
               jmask: bool = False):
        """``select_turns``' picks for the queues ``q`` i64[S] whose rows
        pass ``ok`` bool[S]: (j i64[S], has_job, g i64[S], has_grp, the
        job mask bool[S, J] when ``jmask``, else None)."""
        out = self._outputs(q.shape[0], "select", jmask)
        if self.dev.type == "cpu":
            self._plain(q, ok, job_has_pending, job_ready, job_share, grp_elig, out)
        else:
            self._launch(out, q, ok, None, None, job_has_pending, job_ready, job_share, grp_elig)
        return out["j"], out["has_job"], out["g"], out["has_grp"], out["jmask"]

    def pop_rows(self, S: int):
        """The plan-owned tensors :meth:`pop` writes at ``S`` rows: (j
        i32[S], g i32[S], has_grp, pop, burn_now), for a plan that binds
        them (K15's)."""
        out = self._outputs(S, "pop", False)
        return out["j"], out["g"], out["has_grp"], out["pop"], out["burn"]

    def pop(self, q: torch.Tensor, q_entry: torch.Tensor, queue_alloc: torch.Tensor,
            job_has_pending: torch.Tensor, job_ready: torch.Tensor, job_share: torch.Tensor,
            grp_elig: torch.Tensor):
        """The reclaim pops of the queues ``q`` (i64[S]) with entry
        budgets ``q_entry`` i32[S] at ``queue_alloc``: (j i32[S], g
        i32[S], has_grp, pop, burn_now)."""
        if self.deserved is None:
            raise ValueError("turn_pick: pop rows need the plan's deserved")
        out = self._outputs(q.shape[0], "pop", False)
        if self.dev.type == "cpu":
            st = self.st
            q_over = q_over_plain(q, queue_alloc, self.deserved)
            active = st.queue_valid[q] & (q_entry > 0)
            self._plain(q, active & ~q_over, job_has_pending, job_ready, job_share, grp_elig, out)
            out["pop"].copy_(active & ~q_over & out["has_job"])
            out["burn"].copy_(active & (q_over | ~out["has_job"]))
        else:
            self._launch(out, q, None, q_entry, queue_alloc, job_has_pending, job_ready,
                         job_share, grp_elig)
        return self.pop_rows(q.shape[0])
