"""K7's and K10's plans, held against the JAX package.

* ``CanonPickPlan`` at every launch of a whole ``_reclaim_canon`` action
  (the plan bound once, K8 committing between launches): each pick
  equals ``canon_pick_plain``'s on the state of that turn and the
  reference's first-fit node (``_canon_elig``, the own-queue exclusion,
  ``_canon_per_node``, ``_fit_feasible``, the first feasible node), and
  the action's final state equals the reference's ``_reclaim_canon``.
* ``TurnFillPlan`` at every launch of a whole immediate allocate and
  backfill (binpack and first fit, with and without pod affinity), in
  both routes (on the CPU either route decodes through
  ``turn_fill_plain``; the route is chosen as on the card): every tensor
  it writes equals ``turn_fill_plain``'s on a copy of the turn's inputs,
  and the actions' states equal the reference's
  ``allocate_action(turn_batch=False)``.
* The group -> task index and its check: dense ranks pass (route
  ``by_group``); a duplicated or out-of-range rank fails it (route
  ``walk``), and both routes still equal the plain version.
* Plan-owned outputs: ``pick``, ``placed`` and ``use_rel`` are the plan's
  own tensors, overwritten by the next launch, on the CPU too.  (The
  plans' ctypes structs are held against the .cu structs in
  tests/test_torch_turn_plans.py.)
* On a card (``cuda``-marked, skipped here): both plans, every route,
  against their plain versions, one launch a call.

Device units are integers and sums stay under 2^24, so everything is
compared bit for bit (tolerance: none).
"""
from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.ops import allocate as ref_alloc
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import canon_pick as k7
from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9
from kube_arbitrator_tpu_torch.ops.kernels import turn_fill as k10

RECLAIM_FIELDS = (
    "task_status", "task_node", "evicted_for", "job_ready_cnt", "group_placed", "job_alloc",
    "queue_alloc", "node_num_tasks", "node_releasing", "node_ports", "evict_claimant",
    "evict_phase", "evict_round",
)
ALLOC_FIELDS = (
    "task_status", "task_node", "job_alloc", "queue_alloc", "job_ready_cnt", "group_placed",
    "group_unfit", "node_idle", "node_releasing", "node_ports", "node_num_tasks",
)
NODE_TASK = ("node_idle", "node_releasing", "node_ports", "node_num_tasks", "task_status",
             "task_node")


def _world(tasks, nodes, seed, running, pod_affinity=False, queues=8, per_job=50, fit=1.0):
    """(port pack on the CPU, reference pack) of one synthetic world with
    integral capacities."""
    arrays, _ = build_synthetic_arrays(tasks, nodes, num_queues=queues, tasks_per_job=per_job,
                                       seed=seed, running_fraction=running, fit_fraction=fit,
                                       pod_affinity=pod_affinity)
    cap = arrays["node_alloc"][arrays["node_valid"]]
    assert np.array_equal(cap, np.round(cap)), "node capacities must be integral"
    ref_st = ref_snapshot.SnapshotTensors(
        **{k: jnp.asarray(v) for k, v in arrays.items() if k != "rv_window"},
        rv_window=arrays["rv_window"])
    return from_numpy(arrays, "cpu"), ref_st


def _ref_tiers(policy):
    tiers = list(ref_ord.DEFAULT_TIERS)
    if policy != "first_fit":
        opt = ref_ord.PluginOption.of("nodeorder", arguments=(("policy", policy),))
        tiers[1] = ref_ord.Tier(plugins=tiers[1].plugins + (opt,))
    return tuple(tiers)


def _assert_state_equal(ref, port, fields, ctx=""):
    for f in fields:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{ctx}{f} diverged"
    assert int(ref.rounds) == port.rounds, f"{ctx}rounds {int(ref.rounds)} vs {port.rounds}"


# ---------------------------------------------------------------- K7


def _ref_pick(ref_st, ref_ctx, plan, q, g, has_grp, pop, req) -> int:
    """The reference's first-fit node of one canon turn on the state the
    plan reads (N when none is feasible)."""
    cand, rank_nj, cum_nq, jrc, min_avail, qalloc, nports, nnt = (
        jnp.asarray(t.numpy()) for t in plan.state)
    use_gang, use_prop, preds_on = plan.flags
    sess = types.SimpleNamespace(min_avail=min_avail)
    state = types.SimpleNamespace(job_ready_cnt=jrc, queue_alloc=qalloc, node_ports=nports,
                                  node_num_tasks=nnt)
    elig = ref_pre._canon_elig(sess, state, ref_ctx, cand, rank_nj, cum_nq, use_gang, use_prop)
    per_node = ref_pre._canon_per_node(ref_st, ref_ctx, elig & (ref_ctx.cq != int(q[0])), False)
    feas = ref_pre._fit_feasible(ref_st, state, preds_on, int(g[0]), jnp.asarray(bool(has_grp)),
                                 jnp.asarray(req.numpy()), jnp.asarray(bool(pop)),
                                 per_node[:, 0], per_node[:, 1:])
    N = ref_st.num_nodes
    return int(jnp.where(jnp.any(feas), jnp.argmin(jnp.where(feas, jnp.arange(N), N)), N))


@pytest.mark.parametrize("seed,running", [(5, 0.5), (6, 0.7)])
def test_canon_pick_plan_at_every_launch_of_a_canon_walk(monkeypatch, seed, running):
    pst, ref_st = _world(2000, 200, seed, running)
    tiers, ref_tiers = port_ord.DEFAULT_TIERS, ref_ord.DEFAULT_TIERS
    rsess, rstate = jax.jit(lambda s: ref_cycle.open_session(s, ref_tiers))(ref_st)
    ref_ctx = ref_pre._canon_ctx(ref_st, rsess)
    seen = dict(plans=0, launches=0, picks=0, none=0)
    made, call = k7.CanonPickPlan.__init__, k7.CanonPickPlan.__call__

    def init(self, *a, **kw):
        made(self, *a, **kw)
        seen["plans"] += 1

    def checked(self, q, g, has_grp, pop, req):
        want = k7.canon_pick_plain(self.st, self.ctx, *self.state, q, g, has_grp, pop, req,
                                   *self.flags)
        ref = _ref_pick(ref_st, ref_ctx, self, q, g, has_grp, pop, req)
        got = call(self, q, g, has_grp, pop, req)
        assert got is self.pick, "the plan's own pick"
        assert torch.equal(got, want) and int(got) == ref, (int(got), int(want), ref)
        seen["launches"] += 1
        seen["picks"] += int(got) < self.st.num_nodes
        seen["none"] += int(got) == self.st.num_nodes
        return got

    monkeypatch.setattr(k7.CanonPickPlan, "__init__", init)
    monkeypatch.setattr(k7.CanonPickPlan, "__call__", checked)
    psess, pstate = port_cycle.open_session(pst, tiers)
    out = port_pre._reclaim_canon(pst, psess, pstate, tiers, 100_000)
    monkeypatch.undo()
    assert seen["plans"] == 1, "one K7 plan a canon walk"
    assert seen["launches"] > 10 and seen["picks"] > 1 and seen["none"] > 0, seen
    want = jax.jit(lambda s, se, a: ref_pre._reclaim_canon(s, se, a, ref_tiers, 100_000))(
        ref_st, rsess, rstate)
    _assert_state_equal(want, out, RECLAIM_FIELDS, "reclaim canon: ")


def test_canon_pick_plan_owns_its_pick_and_matches_the_functional_form():
    pst, _ = _world(2000, 200, 3, 0.5)
    tiers = port_ord.DEFAULT_TIERS
    psess, state = port_cycle.open_session(pst, tiers)
    ctx = port_pre._canon_ctx(pst, psess)
    carry = port_pre._canon_seed(pst, state, ctx)
    flags = port_pre._reclaim_flags(tiers)
    plan = port_pre._pick_plan(pst, psess, state, ctx, carry, *flags)
    nq, perm = port_pre._canon_round_order(pst, psess, tiers, state, carry)
    picks = []
    for qi in range(int(nq)):
        q = perm[qi:qi + 1]
        shared = port_pre._reclaim_shared(pst, psess, state, tiers, carry.job_consumed)
        _, g, has_grp, req, pop, _ = port_pre._reclaim_pop(pst, psess, state, tiers, shared, q,
                                                           carry.q_entries[q])
        got = plan(q, g, has_grp, pop, req)
        for q_, g_ in ((q, g), (q.to(torch.int32), g.to(torch.int32))):
            fn = k7.canon_pick(pst, ctx, carry.cand, carry.rank_nj, carry.cum_nq,
                               state.job_ready_cnt, psess.min_avail, state.queue_alloc,
                               state.node_ports, state.node_num_tasks, q_, g_, has_grp, pop, req,
                               *flags)
            assert torch.equal(fn, got) and fn is not plan.pick
        picks.append((got, int(got), (q, g, has_grp, pop, req)))
    assert len(picks) > 1 and all(any(p is w for w in plan.words) for p, _, _ in picks), \
        "the plan's own two words"
    kept, value, (q, g, has_grp, pop, req) = next(x for x in picks if x[1] < pst.num_nodes)
    plan(q, g, has_grp, torch.zeros_like(pop), req)  # a turn that does not pop: pick N
    assert int(kept) == pst.num_nodes != value, "a kept pick is overwritten by the next launch"


# ---------------------------------------------------------------- K10


def _track_fill_launches(monkeypatch, variant=None):
    """Check every TurnFillPlan launch against the plain version on copies
    of its inputs; ``variant`` forces the route of every plan."""
    seen = dict(plans=0, launches=0, placed=0, routes=set())
    made, call = k10.TurnFillPlan.__init__, k10.TurnFillPlan.__call__

    def init(self, *a, **kw):
        if variant is not None:
            kw["variant"] = variant
        made(self, *a, **kw)
        seen["plans"] += 1
        seen["routes"].add(self.variant)

    def checked(self, g, req, budget):
        k, nperm = self.rows
        inputs = [t.clone() for t in self.state]
        want = k10.turn_fill_plain(self.st, k.clone(), None if nperm is None else nperm.clone(),
                                   g, req, budget, *inputs, self.s_max, self.best_effort,
                                   self.preds_on)
        got = call(self, g, req, budget)
        assert got[0] is self.placed and got[1] is self.use_rel, "the plan's own outputs"
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for name, a, b in zip(("group_placed",) + NODE_TASK, self.state, inputs):
            assert torch.equal(a, b), f"{self.variant}: {name}"
        seen["launches"] += 1
        seen["placed"] += int(got[0])
        return got

    monkeypatch.setattr(k10.TurnFillPlan, "__init__", init)
    monkeypatch.setattr(k10.TurnFillPlan, "__call__", checked)
    return seen


@pytest.mark.parametrize("variant", [None, "walk"])
@pytest.mark.parametrize("policy,pod_affinity", [("binpack", False), ("first_fit", False),
                                                 ("binpack", True), ("first_fit", True)])
def test_turn_fill_plan_at_every_launch_of_an_immediate_action(monkeypatch, policy,
                                                               pod_affinity, variant):
    pst, ref_st = _world(2000, 200, 3, 0.3, pod_affinity=pod_affinity)
    tiers, ref_tiers = port_ord.with_node_order(policy), _ref_tiers(policy)
    psess, pstate = port_cycle.open_session(pst, tiers)
    rsess, rstate = ref_cycle.open_session(ref_st, ref_tiers)
    seen = _track_fill_launches(monkeypatch, variant)
    for best_effort in (False, True):
        pstate = port_alloc.allocate_action(pst, psess, pstate, tiers, best_effort_pass=best_effort,
                                            turn_batch=False)
        rstate = ref_alloc.allocate_action(ref_st, rsess, rstate, ref_tiers,
                                           best_effort_pass=best_effort, turn_batch=False)
        _assert_state_equal(rstate, pstate, ALLOC_FIELDS, f"{policy} best_effort={best_effort}: ")
    monkeypatch.undo()
    assert seen["plans"] == 2, "one K10 plan an action"
    assert seen["routes"] == {variant or "by_group"}
    assert seen["launches"] > 20 and seen["placed"] > 100, seen


def _pack_with_ranks(pst, rank):
    return dataclasses.replace(pst, task_group_rank=rank)


def test_group_index_dense_ranks():
    pst, _ = _world(2000, 200, 3, 0.3)
    G = pst.group_ports.shape[0]
    gstart, gidx, ok = k10.group_index_plain(pst.task_group, pst.task_group_rank, pst.task_valid,
                                             G)
    assert ok
    member = pst.task_valid & (pst.task_group >= 0)
    assert int(gstart[-1]) == int(member.sum()) and gstart.dtype == torch.int32
    for g in range(G):
        t = gidx[int(gstart[g]):int(gstart[g + 1])].long()
        assert torch.equal(pst.task_group[t], torch.full_like(pst.task_group[t], g))
        assert torch.equal(pst.task_group_rank[t], torch.arange(t.numel(), dtype=torch.int32))


@pytest.mark.parametrize("fault", ["duplicated", "out_of_range", "negative"])
def test_group_index_check_fails_and_walk_still_equals_plain(fault):
    pst, _ = _world(2000, 200, 3, 0.3)
    tiers = port_ord.with_node_order("binpack")
    psess, state = port_cycle.open_session(pst, tiers)
    shared = port_alloc._selection_shared(pst, psess, state, tiers, False)
    nq, perm = port_alloc.queue_perm(tiers, pst.queue_valid, state.queue_alloc, psess.deserved,
                                     pst.queue_uid_rank)
    q = perm[:1]
    _, g, _, req, budget = port_alloc.select_turns(pst, psess, state, tiers, 4096, "allocate",
                                                   shared, q, pst.queue_valid[q])
    rank = pst.task_group_rank.clone()
    members = torch.nonzero((pst.task_group == int(g)) & pst.task_valid).reshape(-1)
    rank[members[1]] = {"duplicated": rank[members[0]], "out_of_range": 10_000,
                        "negative": -1}[fault]
    bad = _pack_with_ranks(pst, rank)
    G = pst.group_ports.shape[0]
    assert not k10.group_index_plain(bad.task_group, bad.task_group_rank, bad.task_valid, G)[2]
    caps = k9.TurnCapsPlan(bad, state.node_idle, state.node_releasing, state.node_ports,
                           state.node_num_tasks, 4096, False, True, "binpack")
    caps(g, req[0], None)
    work = [getattr(state, n).clone() for n in NODE_TASK]
    plan = k10.TurnFillPlan(bad, caps.k, caps.nperm, state.group_placed, *work, 4096, False,
                            True)
    assert plan.variant == "walk"
    with pytest.raises(ValueError, match="index check"):
        k10.TurnFillPlan(bad, caps.k, caps.nperm, state.group_placed, *work, 4096, False, True,
                         "by_group")
    cpu = [getattr(state, n).clone() for n in NODE_TASK]
    got = plan(g, req[0], budget)
    want = k10.turn_fill_plain(bad, caps.k, caps.nperm, g, req[0], budget, state.group_placed,
                               *cpu, 4096, False, True)
    assert int(got[0]) > 1 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(work, cpu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s_max,before", [(4096, 0), (8, 0), (4096, 5), (3, 7)])
def test_turn_fill_routes_edge_cases(s_max, before):
    """Slots past s_max take slot s_max - 1's node; tasks already placed
    shift the ranks; ranks past the group's count assign nothing; the
    releasing fallback; first fit (no order)."""
    pst, _ = _world(2000, 200, 3, 0.3)
    tiers = port_ord.with_node_order("binpack")
    psess, state = port_cycle.open_session(pst, tiers)
    shared = port_alloc._selection_shared(pst, psess, state, tiers, False)
    nq, perm = port_alloc.queue_perm(tiers, pst.queue_valid, state.queue_alloc, psess.deserved,
                                     pst.queue_uid_rank)
    q = perm[:1]
    _, g, _, req, _ = port_alloc.select_turns(pst, psess, state, tiers, 4096, "allocate", shared,
                                              q, pst.queue_valid[q])
    gp = state.group_placed.clone()
    gp[g] += before
    count = int(((pst.task_group == int(g)) & pst.task_valid).sum())
    for policy in ("binpack", "first_fit"):
        caps = k9.TurnCapsPlan(pst, state.node_idle, state.node_releasing, state.node_ports,
                               state.node_num_tasks, s_max, False, True, policy)
        k, nperm = caps(g, req[0], None)
        k_rel = torch.stack([torch.zeros_like(k[0]), k[0]])
        for rows, what in ((k, "idle"), (k_rel, "releasing fallback")):
            for budget in (torch.tensor([count + 7], dtype=torch.int32),
                           torch.tensor([max(count // 2, 1)], dtype=torch.int32)):
                outs = []
                for variant in k10.VARIANTS:
                    work = [getattr(state, n).clone() for n in NODE_TASK]
                    plan = k10.TurnFillPlan(pst, rows, nperm, gp, *work, s_max, False, True,
                                            variant)
                    got = plan(g, req[0], budget)
                    outs.append((got, work))
                cpu = [getattr(state, n).clone() for n in NODE_TASK]
                want = k10.turn_fill_plain(pst, rows, nperm, g, req[0], budget, gp, *cpu, s_max,
                                           False, True)
                assert bool(want[1]) == (what != "idle")
                for (got, work) in outs:
                    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                    for name, a, b in zip(NODE_TASK, work, cpu):
                        assert torch.equal(a, b), f"{policy} {what} s_max={s_max}: {name}"


def test_turn_fill_plan_owns_its_outputs():
    pst, _ = _world(2000, 200, 3, 0.3)
    tiers = port_ord.with_node_order("binpack")
    psess, state = port_cycle.open_session(pst, tiers)
    caps, _, _, fill = port_alloc._turn_plans(pst, state, 4096, False, "binpack", True, False)
    kept = []
    for _ in range(3):
        shared = port_alloc._selection_shared(pst, psess, state, tiers, False)
        nq, perm = port_alloc.queue_perm(tiers, pst.queue_valid, state.queue_alloc,
                                         psess.deserved, pst.queue_uid_rank)
        q = perm[:1]
        _, g, _, req, budget = port_alloc.select_turns(pst, psess, state, tiers, 4096, "allocate",
                                                       shared, q, pst.queue_valid[q])
        caps(g, req[0], None)
        placed, use_rel = fill(g, req[0], budget)
        assert placed is fill.placed and use_rel is fill.use_rel
        kept.append((placed, int(placed)))
        state.group_placed.index_put_((g,), placed, accumulate=True)
        state.job_alloc.index_put_((pst.group_job[g].long(),),
                                   placed.float()[:, None] * req, accumulate=True)
    assert all(p is fill.placed for p, _ in kept)
    assert int(kept[0][0]) == kept[-1][1], "a kept placed count is overwritten by the next launch"


# ---------------------------------------------------------------- on a card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _to(getattr(x, f.name), dev)
                                         for f in dataclasses.fields(x)})
    return x


@pytest.mark.cuda
def test_canon_pick_plan_on_card(cuda_device):
    pst, _ = _world(2000, 200, 5, 0.5)
    tiers = port_ord.DEFAULT_TIERS
    st = _to(pst, cuda_device)
    psess, state = port_cycle.open_session(st, tiers)
    ctx = port_pre._canon_ctx(st, psess)
    carry = port_pre._canon_seed(st, state, ctx)
    flags = port_pre._reclaim_flags(tiers)
    plan = port_pre._pick_plan(st, psess, state, ctx, carry, *flags)
    nq, perm = port_pre._canon_round_order(st, psess, tiers, state, carry)
    for qi in range(int(nq)):
        q = perm[qi:qi + 1]
        shared = port_pre._reclaim_shared(st, psess, state, tiers, carry.job_consumed)
        _, g, has_grp, req, pop, _ = port_pre._reclaim_pop(st, psess, state, tiers, shared, q,
                                                           carry.q_entries[q])
        n0 = k7.canon_pick.launches
        got = plan(q, g, has_grp, pop, req)
        assert k7.canon_pick.launches == n0 + 1
        want = k7.canon_pick_plain(st, ctx, carry.cand, carry.rank_nj, carry.cum_nq,
                                   state.job_ready_cnt, psess.min_avail, state.queue_alloc,
                                   state.node_ports, state.node_num_tasks, q, g, has_grp, pop,
                                   req, *flags)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", k10.VARIANTS)
def test_turn_fill_plan_on_card(cuda_device, variant):
    pst, _ = _world(2000, 200, 3, 0.3)
    tiers = port_ord.with_node_order("binpack")
    st = _to(pst, cuda_device)
    psess, state = port_cycle.open_session(st, tiers)
    shared = port_alloc._selection_shared(st, psess, state, tiers, False)
    nq, perm = port_alloc.queue_perm(tiers, st.queue_valid, state.queue_alloc, psess.deserved,
                                     st.queue_uid_rank)
    q = perm[:1]
    _, g, _, req, budget = port_alloc.select_turns(st, psess, state, tiers, 4096, "allocate",
                                                   shared, q, st.queue_valid[q])
    caps = k9.TurnCapsPlan(st, state.node_idle, state.node_releasing, state.node_ports,
                           state.node_num_tasks, 4096, False, True, "binpack")
    k, nperm = caps(g, req[0], None)
    work = [getattr(state, n).clone() for n in NODE_TASK]
    plan = k10.TurnFillPlan(st, k, nperm, state.group_placed, *work, 4096, False, True, variant)
    got = plan(g, req[0], budget)
    cpu = [getattr(state, n).cpu() for n in NODE_TASK]
    want = k10.turn_fill_plain(pst, k.cpu(), nperm.cpu(), g.cpu(), req[0].cpu(), budget.cpu(),
                               state.group_placed.cpu(), *cpu, 4096, False, True)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    for a, b in zip(work, cpu):
        assert torch.equal(a.cpu(), b)
