"""K8's ``CanonCommitPlan`` and K20's ``OrderedScanPlan`` on the CPU, held
against the JAX package (the card's twins, which hold each kernel
against its plain version, are in tests/test_torch_commit_scan_card.py).

* K8: every turn of an evictive world's first reclaim rounds, committed
  through one plan in each canon engine's form (the canon walk's i64
  queue, i64 ordinals, the batched engine's ``claimed_out``, the
  optimistic engine's i32 rows and ``active``), with gang and proportion
  each off, against the reference's ``_canon_fit_commit`` field by field;
  a window whose claim evicts over two jobs and two queues; a launch with
  ``active`` clear changes nothing; ``state.progress`` is set after the
  engines' per-round reset; each engine binds one plan and launches it a
  turn (a window for the optimistic engine) and decides as the
  reference's engine.
* K20: the plan, plain and masked (``where(mask, rows, 0)`` scanned), at
  the recursion's edges against the reference's ``mm_cumsum`` and
  ``ordered_scan_plain``; the plan owns its outputs.

Inputs are made with numpy from a seed.  Every comparison is exact.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.api import TaskStatus
from kube_arbitrator_tpu.cache import SimCluster, build_snapshot
from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import common as ref_common
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import canon_commit as k8
from kube_arbitrator_tpu_torch.ops.kernels import canon_pick as k7
from kube_arbitrator_tpu_torch.ops.kernels import ordered_scan as k20

GB = 1024**3
REF_TIERS = ref_ord.DEFAULT_TIERS
TIERS = port_ord.DEFAULT_TIERS
STATE_FIELDS = ("job_alloc", "queue_alloc", "job_ready_cnt", "group_placed", "node_releasing",
                "node_ports", "node_num_tasks", "evict_claimant", "evict_phase", "evict_round")
CARRY_FIELDS = ("cand", "evicted_c", "rank_nj", "cum_nq", "q_entries", "job_consumed")
FLAGS = {"gang": (True, False), "proportion": (False, True), "both": (True, True)}
# each canon engine's call form: q / j / g dtypes, claimed_out, active
FORMS = {
    "canon": dict(q=torch.int64, jg=torch.int32),
    "canon_i64": dict(q=torch.int64, jg=torch.int64),
    "batched": dict(q=torch.int64, jg=torch.int32, claimed_out=True),
    "optimistic": dict(q=torch.int32, jg=torch.int32, active=True),
}


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def _evictive_world():
    """An evictive world oversubscribed enough that gang and proportion
    each let every round claim (the checks below assert it)."""
    return ref_synth(num_tasks=3000, num_nodes=300, num_queues=8, tasks_per_job=20, seed=5,
                     running_fraction=0.6, fit_fraction=0.6).tensors


def _two_jobs_world():
    """One node, two victim jobs in two queues (three running tasks each,
    gang floor 1), and a claimant in a third queue whose request covers
    four victims: the window's one claim evicts over both jobs and
    queues (memory as oversubscribed as cpu, so that proportion lets each
    victim queue give one task)."""
    sim = SimCluster()
    for name in ("qa", "qb", "qc"):
        sim.add_queue(name, weight=1)
    sim.add_node("n1", cpu_milli=6000, memory=6 * GB)
    for name, ts in (("a", 1), ("b", 2)):
        j = sim.add_job(name, queue=f"q{name}", min_available=1, creation_ts=ts)
        for i in range(3):
            sim.add_task(j, 1000, GB, status=TaskStatus.RUNNING, node="n1", name=f"{name}-r{i}",
                         priority=i)
    jc = sim.add_job("c", queue="qc", min_available=1, creation_ts=3)
    sim.add_task(jc, 3500, 7 * GB // 2, name="c-p0")
    return build_snapshot(sim.cluster).tensors


@functools.lru_cache(maxsize=None)
def _ref_turn(flags):
    """One turn of the reference's canon walk with its node pick exposed,
    under the verdict flags ``flags`` (use_gang, use_prop)."""
    use_gang, use_prop = flags

    def turn(st, sess, ctx, state, q_entries, job_consumed, cand, evicted_c, rank_nj, cum_nq,
             log_g, log_n, log_r, n_claims, q):
        W = st.rv_window
        shared = ref_pre._reclaim_shared(st, sess, state, REF_TIERS, job_consumed)
        j, g, has_grp, req, pop, burn_now = ref_pre._reclaim_pop(
            st, sess, state, REF_TIERS, shared, q, q_entries[q])
        elig = ref_pre._canon_elig(sess, state, ctx, cand, rank_nj, cum_nq, use_gang, use_prop)
        mask_v = elig & (ctx.cq != q)
        per_node = ref_pre._canon_per_node(st, ctx, mask_v, False)
        out, _ = ref_pre._canon_fit_commit(
            st, sess, REF_TIERS, ctx, True, use_gang, use_prop, state, q_entries, job_consumed,
            cand, evicted_c, rank_nj, cum_nq, log_g, log_n, log_r, n_claims,
            q, j, g, has_grp, req, pop, burn_now, per_node[:, 0], per_node[:, 1:],
            lambda start: jax.lax.dynamic_slice(mask_v, (start,), (W,)),
        )
        return out

    return jax.jit(turn)


class _Walk:
    """The reference's canon state and the port's, turn by turn from one
    pack, the port committing through one ``CanonCommitPlan``."""

    def __init__(self, st, flags, form):
        self.st, self.flags, self.form = st, flags, FORMS[form]
        pst = from_numpy(pack_arrays(st), "cpu")
        self.sess, state = ref_cycle.open_session(st, REF_TIERS)
        psess, pstate = port_cycle.open_session(pst, TIERS)
        self.ctx, seed = jax.jit(lambda st_, se, s: (
            ref_pre._canon_ctx(st_, se), ref_pre._canon_seed(st_, s, ref_pre._canon_ctx(st_, se))
        ))(st, self.sess, state)
        cand, rank_nj, cum_nq, q_entries, (log_g, log_n, log_r, n_claims) = seed
        self.ref = [state, q_entries, jnp.zeros(st.num_jobs, bool), cand,
                    jnp.zeros(st.rv_idx.shape[0], bool), rank_nj, cum_nq, log_g, log_n, log_r,
                    n_claims]
        self.pst, self.psess, self.pstate = pst, psess, pstate
        self.pctx = port_pre._canon_ctx(pst, psess)
        pstate.progress = torch.zeros((), dtype=torch.bool)
        pstate.rounds = 0
        self.carry = port_pre._canon_seed(pst, pstate, self.pctx)
        self.plan = k8.CanonCommitPlan(pst, self.pctx, pstate, self.carry, *flags)

    def start_round(self, rnd):
        """The round counter both walks write into ``evict_round``."""
        self.pstate.rounds = rnd
        self.ref[0] = dataclasses.replace(self.ref[0], rounds=jnp.int32(rnd))

    def round_order(self):
        nq, perm = port_pre._canon_round_order(self.pst, self.psess, TIERS, self.pstate,
                                               self.carry)
        return int(nq), perm

    def pop(self, q):
        shared = port_pre._reclaim_shared(self.pst, self.psess, self.pstate, TIERS,
                                          self.carry.job_consumed)
        return port_pre._reclaim_pop(self.pst, self.psess, self.pstate, TIERS, shared, q,
                                     self.carry.q_entries[q])

    def turn(self, q, off_first=False):
        """One turn of queue ``q`` (i64[1]) on both sides; the port's
        claimed_out (when the form takes it).  ``off_first``: a launch with
        ``active`` clear goes first and must change nothing."""
        j, g, has_grp, req, pop, burn = self.pop(q)
        c = self.carry
        pick = k7.canon_pick_plain(self.pst, self.pctx, c.cand, c.rank_nj, c.cum_nq,
                                   self.pstate.job_ready_cnt, self.psess.min_avail,
                                   self.pstate.queue_alloc, self.pstate.node_ports,
                                   self.pstate.node_num_tasks, q, g, has_grp, pop, req,
                                   *self.flags, True)
        qq, jj, gg = q.to(self.form["q"]), j.to(self.form["jg"]), g.to(self.form["jg"])
        kw = {}
        if self.form.get("claimed_out"):
            kw["claimed_out"] = torch.ones(1, dtype=torch.bool)
        if self.form.get("active") or off_first:
            if off_first:
                before = self.snapshot()
                self.plan(pick, qq, jj, gg, has_grp, pop, burn, req,
                          active=torch.zeros(1, dtype=torch.bool), **kw)
                after = self.snapshot()
                assert all(torch.equal(before[k], after[k]) for k in before), "active clear"
            kw["active"] = torch.ones(1, dtype=torch.bool)
        self.plan(pick, qq, jj, gg, has_grp, pop, burn, req, **kw)
        self.ref = list(_ref_turn(self.flags)(self.st, self.sess, self.ctx, *self.ref,
                                              jnp.int32(int(q))))
        return kw.get("claimed_out"), bool(pop) and bool(has_grp) and int(pick) < self.st.num_nodes

    def snapshot(self):
        c, s = self.carry, self.pstate
        out = {f: getattr(c, f).clone() for f in CARRY_FIELDS + ("log_g", "log_n", "log_r",
                                                                  "n_claims")}
        out.update({f: getattr(s, f).clone() for f in STATE_FIELDS})
        out["progress"] = s.progress.clone()
        return out

    def assert_equal(self, what):
        state, q_entries, job_consumed, cand, evicted_c, rank_nj, cum_nq, log_g, log_n, log_r, \
            n_claims = self.ref
        c, J = self.carry, self.st.num_jobs
        for name, a, b in (
            ("cand", cand, c.cand), ("evicted_c", evicted_c, c.evicted_c),
            ("rank_nj", rank_nj, c.rank_nj), ("cum_nq", cum_nq, c.cum_nq),
            ("q_entries", q_entries, c.q_entries), ("job_consumed", job_consumed, c.job_consumed),
            ("log_g", log_g, c.log_g[:J]), ("log_n", log_n, c.log_n[:J]),
            ("log_r", log_r, c.log_r[:J]), ("n_claims", n_claims, c.n_claims[0]),
        ):
            assert np.array_equal(np.asarray(a), b.numpy()), (what, name)
        for f in STATE_FIELDS:
            assert np.array_equal(np.asarray(getattr(state, f)), getattr(self.pstate, f).numpy()), \
                (what, f)


# ---------------------------------------------------------------- K8


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_commit_plan_turns_match_reference(form, flags):
    """Every turn of the first two reclaim rounds, one plan, each engine's
    call form, against the reference's turn field by field; the claimed
    bit out where the form asks for it; a first launch with ``active``
    clear changes nothing."""
    w = _Walk(_evictive_world(), FLAGS[flags], form)
    turns = claims = 0
    for rnd in range(2):
        nq, perm = w.round_order()
        w.start_round(rnd)
        for qi in range(max(nq, 1)):
            claimed_out, claimed = w.turn(perm[qi:qi + 1], off_first=turns == 0)
            w.assert_equal(f"round {rnd} turn {qi}")
            if claimed_out is not None:
                assert bool(claimed_out) == claimed, f"claimed_out, turn {qi}"
            turns += 1
            claims += claimed
    assert turns >= 8 and claims > 0, (turns, claims)
    assert int((w.carry.evicted_c).sum()) > 0


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_commit_plan_window_over_two_jobs_and_queues(flags):
    """qc's claim evicts a covering prefix of four victims over jobs a and
    b (queues qa and qb): the per-job and per-queue sums each subtract
    once, in slot order, as the reference's."""
    w = _Walk(_two_jobs_world(), FLAGS[flags], "canon")
    nq, perm = w.round_order()
    for qi in range(nq):
        w.turn(perm[qi:qi + 1])
        w.assert_equal(f"queue {qi}")
    ev = w.carry.evicted_c
    assert int(ev.sum()) >= 2
    jobs = set(w.pctx.cj[ev].tolist())
    queues = set(w.pctx.cq[ev].tolist())
    assert len(jobs) == 2 and len(queues) == 2, (jobs, queues)


def test_commit_plan_sets_progress_after_the_round_reset():
    """The engines give ``state.progress`` a new tensor every round; the
    plan writes the one the state holds at each launch."""
    w = _Walk(_evictive_world(), FLAGS["gang"], "canon")
    nq, perm = w.round_order()
    w.turn(perm[:1])
    assert bool(w.pstate.progress)
    w.pstate.progress = torch.zeros((), dtype=torch.bool)  # the next round's reset
    # a turn that does not pop leaves the new flag clear
    j, g, has_grp, req, pop, burn = w.pop(perm[1:2])
    pick = torch.full((1,), w.st.num_nodes, dtype=torch.int32)
    w.plan(pick, perm[1:2], j, g, has_grp, torch.zeros_like(pop), torch.zeros_like(burn), req)
    assert not bool(w.pstate.progress)
    popped = False
    for qi in range(1, nq):
        popped = popped or bool(w.pop(perm[qi:qi + 1])[4])
        w.turn(perm[qi:qi + 1])
        assert bool(w.pstate.progress) == popped, qi
    assert popped


class _Counted(k8.CanonCommitPlan):
    """A plan that counts its binds and launches and the index dtypes it
    was given."""

    binds = 0
    launched = 0
    dtypes = set()

    def __init__(self, *a, **kw):
        type(self).binds += 1
        super().__init__(*a, **kw)

    def __call__(self, pick, q, j, g, *rest, **kw):
        type(self).launched += 1
        type(self).dtypes.add((q.dtype, j.dtype, g.dtype))
        return super().__call__(pick, q, j, g, *rest, **kw)


@functools.lru_cache(maxsize=None)
def _ref_engine(name):
    return jax.jit(lambda st, se, s: getattr(ref_pre, name)(st, se, s, REF_TIERS, 100_000))


@pytest.mark.parametrize("engine,turn_batch,want_q", [
    ("_reclaim_canon", None, torch.int64), ("_reclaim_canon_batched", True, torch.int64),
    ("_reclaim_canon_optimistic", "optimistic", torch.int32)])
def test_each_engine_binds_one_commit_plan(monkeypatch, engine, turn_batch, want_q):
    """Each canon engine binds K8's plan once per call, commits through it
    (a turn; a window for the optimistic engine) with its ordinals as
    they come (no cast for K8), and decides as the reference's engine."""
    monkeypatch.setattr(_Counted, "binds", 0)
    monkeypatch.setattr(_Counted, "launched", 0)
    monkeypatch.setattr(_Counted, "dtypes", set())
    monkeypatch.setattr(port_pre, "CanonCommitPlan", _Counted)
    st = _evictive_world()
    sess, state = jax.jit(lambda s: ref_cycle.open_session(s, REF_TIERS))(st)
    pst = from_numpy(pack_arrays(st), "cpu")
    psess, pstate = port_cycle.open_session(pst, TIERS)
    ref = _ref_engine(engine)(st, sess, state)
    port = port_pre.reclaim_action(pst, psess, pstate, TIERS, turn_batch=turn_batch)
    for f in STATE_FIELDS + ("task_status", "task_node", "evicted_for"):
        assert np.array_equal(np.asarray(getattr(ref, f)), getattr(port, f).numpy()), f
    assert port.rounds == int(ref.rounds)
    assert _Counted.binds == 1 and _Counted.launched > port.rounds
    if turn_batch == "optimistic":
        assert _Counted.launched == port.windows
    assert {d[0] for d in _Counted.dtypes} == {want_q}
    assert {d[1:] for d in _Counted.dtypes} == {(torch.int32, torch.int32)}


# ---------------------------------------------------------------- K20


def _scan_input(V, C, seed):
    rng = np.random.default_rng(seed)
    x = (rng.integers(1, 64_000, size=(V, C)) * rng.random((V, C))).astype(np.float32)
    x[rng.random((V, C)) < 0.05] = -0.0
    return x


@pytest.mark.parametrize("C", (1, 3, 4))
@pytest.mark.parametrize("V", (1, 16, 17, 4095, 4096, 4097, 51_200, 65_537))
def test_scan_plan_matches_reference(V, C):
    """The plan's scan, plain and masked, equals the reference's
    ``mm_cumsum`` (``jnp.cumsum`` on the CPU) bit for bit; ``masked`` is
    ``where(mask, rows, 0)``; the outputs are the plan's own, overwritten
    by its next launch."""
    x = _scan_input(V, C, V + C)
    mask = np.random.default_rng(V).random(V) < 0.7
    xm = np.where(mask[:, None], x, np.float32(0.0))
    want = np.asarray(ref_common.mm_cumsum(jnp.asarray(x)))
    want_m = np.asarray(ref_common.mm_cumsum(jnp.asarray(xm)))
    plan = k20.OrderedScanPlan(V, C, "cpu")
    got = plan(torch.from_numpy(x))
    assert got is plan.out and np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert torch.equal(got, k20.ordered_scan_plain(torch.from_numpy(x)))
    rows = torch.from_numpy(x)
    mplan = k20.OrderedScanPlan(V, C, "cpu", rows=rows)
    got_m = mplan(mask=torch.from_numpy(mask))
    assert got_m is mplan.out
    assert np.array_equal(got_m.numpy().view(np.int32), want_m.view(np.int32))
    assert np.array_equal(mplan.masked.numpy().view(np.int32), xm.view(np.int32))
    again = mplan(mask=torch.from_numpy(~mask))
    assert again is got_m and torch.equal(again, k20.ordered_scan_plain(
        k20.masked_rows_plain(torch.from_numpy(~mask), rows)))


def test_scan_plan_refuses_the_wrong_call():
    plan = k20.OrderedScanPlan(8, 2, "cpu")
    with pytest.raises(TypeError):
        plan(mask=torch.ones(8, dtype=torch.bool))
    mplan = k20.OrderedScanPlan(8, 2, "cpu", rows=torch.ones(8, 2))
    with pytest.raises(TypeError):
        mplan(torch.ones(8, 2))
    with pytest.raises(TypeError):
        k20.OrderedScanPlan(8, 2, "cpu", rows=torch.ones(8, 3))
