"""The port's opt-in reclaim engines (the round-batched and the optimistic
canon reclaim), the ``reclaim_optimistic`` action, the staged cycle
runner and the plain versions of K13-K16, held against the JAX package.

The same numpy pack goes through the reference (JAX on the CPU at its
default ``native_ops=False``) and through the port on the CPU (the
kernels' plain versions).  Resource requests are integers in device
units and every sum stays below 2^24, so each compared field must be
equal (tolerance: none), the engines' counters (rounds, gated rounds,
claim conflicts) included; the one exception is ``queue_deserved`` at
64+ weighted queues (rtol 1e-5, ROADMAP queue C).
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.api import PodAffinityTerm, TaskStatus
from kube_arbitrator_tpu.cache import SimCluster, build_snapshot, generate_cluster
from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import allocate as ref_alloc
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import union_fit as k14
from kube_arbitrator_tpu_torch.ops.kernels import window_gate as k15

GB = 1024**3
FIELDS = (
    "task_status", "task_node", "evicted_for", "job_ready_cnt", "group_placed",
    "job_alloc", "queue_alloc", "node_num_tasks", "node_releasing", "node_ports",
    "evict_claimant", "evict_phase", "evict_round",
)
REF_TIERS = ref_ord.DEFAULT_TIERS
TIERS = port_ord.DEFAULT_TIERS
ENGINES = ("_reclaim_canon_batched", "_reclaim_canon_optimistic")
TURN_BATCH = {"_reclaim_canon_batched": True, "_reclaim_canon_optimistic": "optimistic"}
EVICTIVE = ("reclaim_optimistic", "allocate", "backfill", "preempt")


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def t(a):
    return torch.from_numpy(np.array(a))


def assert_state_equal(ref, port, ctx="", counters=True):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(ref, f)), getattr(port, f).numpy()), f"{ctx}{f}"
    assert int(ref.rounds) == port.rounds, f"{ctx}rounds {int(ref.rounds)} vs {port.rounds}"
    if counters:
        assert int(ref.rounds_gated) == port.rounds_gated, f"{ctx}rounds_gated"
        assert int(ref.claim_conflicts) == port.claim_conflicts, f"{ctx}claim_conflicts"


def assert_decisions_equal(ref, port, ctx=""):
    for f in dataclasses.fields(port):
        a, b = np.asarray(getattr(ref, f.name)), getattr(port, f.name).numpy()
        if f.name == "queue_deserved":
            np.testing.assert_allclose(b, a, rtol=1e-5)  # ROADMAP queue C
        else:
            assert np.array_equal(a, b), f"{ctx}{f.name}"


@functools.lru_cache(maxsize=None)
def _ref_engine(name):
    return jax.jit(lambda st, se, s: getattr(ref_pre, name)(st, se, s, REF_TIERS, 100_000))


_ref_open = jax.jit(lambda st: ref_cycle.open_session(st, REF_TIERS))


def _both(st):
    """(reference entry, port pack, port entry) of one pack."""
    pst = from_numpy(pack_arrays(st), "cpu")
    return _ref_open(st), pst, port_cycle.open_session(pst, TIERS)


def _synth(tasks, nodes, queues, seed, running, fit=1.25, per_job=20):
    return ref_synth(num_tasks=tasks, num_nodes=nodes, num_queues=queues, tasks_per_job=per_job,
                     seed=seed, running_fraction=running, fit_fraction=fit).tensors


# ---------------------------------------------------------------- the engines


WORLDS = {
    "q8": lambda: _synth(4000, 400, 8, 1, 0.5),
    "q64": lambda: _synth(4000, 400, 64, 1, 0.5),
    "q4_dense": lambda: _synth(2000, 200, 4, 1, 0.7),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_engines_match_reference(world, engine):
    """Each engine equals the reference's engine of the same name in
    every state field and counter, and the port's own canon walk in
    every state field and the round count."""
    st = WORLDS[world]()
    (sess, state), pst, (psess, pstate) = _both(st)
    ref = _ref_engine(engine)(st, sess, state)
    port = port_pre.reclaim_action(pst, psess, pstate, TIERS, turn_batch=TURN_BATCH[engine])
    assert_state_equal(ref, port, f"{world} {engine}: ")
    canon = port_pre.reclaim_action(pst, psess, pstate, TIERS)
    assert_state_equal(canon, port, f"{world} {engine} vs canon: ", counters=False)
    assert (port.evict_phase.numpy() == 3).sum() > 0
    assert port.rounds_gated <= port.rounds
    if engine == "_reclaim_canon_optimistic":
        assert port.windows >= port.rounds and port.claim_conflicts > 0
    else:
        assert port.claim_conflicts == 0
    assert torch.equal(pstate.task_status, pst.task_status)  # the caller's state is left alone


def _two_queue_world(affinity=()):
    sim = SimCluster()
    for name in ("qa", "qb", "qc"):
        sim.add_queue(name, weight=1)
    sim.add_node("n1", cpu_milli=4000, memory=8 * GB)
    ja = sim.add_job("a", queue="qa", creation_ts=1)
    for i in range(4):
        sim.add_task(ja, 1000, GB, status=TaskStatus.RUNNING, node="n1", name=f"a-r{i}",
                     priority=i)
    for name, ts in (("b", 2), ("c", 3)):
        j = sim.add_job(name, queue=f"q{name}", min_available=1, creation_ts=ts)
        sim.add_task(j, 1000, GB, name=f"{name}-p0", labels={"app": "x"} if affinity else None,
                     affinity=affinity)
    return sim


def test_two_queues_one_victim_counts_the_conflict():
    """qb and qc reclaim from qa's one node: both claim in the optimistic
    engine's first window; the second is a conflict, discarded and
    re-derived, and every engine decides alike."""
    st = build_snapshot(_two_queue_world().cluster).tensors
    (sess, state), pst, (psess, pstate) = _both(st)
    canon = port_pre.reclaim_action(pst, psess, pstate, TIERS)
    for engine in ENGINES:
        ref = _ref_engine(engine)(st, sess, state)
        port = port_pre.reclaim_action(pst, psess, pstate, TIERS, turn_batch=TURN_BATCH[engine])
        assert_state_equal(ref, port, f"{engine}: ")
        assert_state_equal(canon, port, f"{engine} vs canon: ", counters=False)
    assert port.claim_conflicts >= 1 and port.claim_conflicts == int(ref.claim_conflicts)
    assert (port.evict_phase.numpy() == 3).sum() == 2


def _stripped(arrays):
    out = dict(arrays)
    for k in ("rv_idx", "rv_valid", "rv_nj_start", "rv_nq_start", "rv_block_start"):
        out[k] = out[k][:0]
    out["rv_window"] = 0
    return out


@pytest.mark.parametrize("pack", ["pod_affinity", "no_canon_pack"])
def test_reclaim_optimistic_degrades_where_illegal(pack):
    """``reclaim_optimistic`` on a pack the engines cannot take decides
    like ``reclaim`` (and like the reference's cycle) without raising;
    ``turn_batch`` True or "optimistic" raises ValueError there."""
    if pack == "pod_affinity":
        st = build_snapshot(_two_queue_world(affinity=[PodAffinityTerm(
            match_labels=(("app", "x"),), topology_key="zone", anti=True)]).cluster).tensors
        arrays = pack_arrays(st)
    else:
        st0 = build_snapshot(_two_queue_world().cluster).tensors
        arrays = _stripped(pack_arrays(st0))
        st = dataclasses.replace(st0, **{k: v for k, v in arrays.items() if k.startswith("rv_")})
    pst = from_numpy(arrays, "cpu")
    assert port_pre.reclaim_engine_fallback_reason(pst, TIERS) == pack
    assert ref_pre.reclaim_engine_fallback_reason(st, REF_TIERS) == pack
    opt = port_cycle.schedule_cycle(pst, actions=("reclaim_optimistic", "allocate"))
    dflt = port_cycle.schedule_cycle(pst, actions=("reclaim", "allocate"))
    ref = ref_cycle.schedule_cycle(st, actions=("reclaim_optimistic", "allocate"))
    assert_decisions_equal(ref, opt, f"{pack}: ")
    assert_decisions_equal(ref, dflt, f"{pack} default: ")
    assert int(opt.evict_count) > 0
    sess, state = port_cycle.open_session(pst, TIERS)
    for tb in (True, "optimistic"):
        with pytest.raises(ValueError, match="not legal for this snapshot"):
            port_pre.reclaim_action(pst, sess, state, TIERS, turn_batch=tb)


def _stub(nodes, queues, pack=True, pa=False, groups=10, tasks=100):
    """The shape fields the fallback reasons read, for both packages."""
    def mk(zeros):
        return types.SimpleNamespace(
            num_nodes=nodes, num_queues=queues, num_groups=groups, num_tasks=tasks,
            rv_block_start=zeros((nodes + 1 if pack else 0,)), rv_idx=zeros((64 if pack else 0,)),
            rv_window=32 if pack else 0, group_aff_terms=zeros((groups, 1 if pa else 0)),
            group_anti_terms=zeros((groups, 0)), symm_ok=zeros((0, 0)),
        )
    return mk(np.zeros), mk(torch.zeros)


@pytest.mark.parametrize("case,want", [
    (dict(nodes=100, queues=8), (None, None)),
    (dict(nodes=100, queues=8, pack=False), ("no_canon_pack", "no_canon_pack")),
    (dict(nodes=100, queues=8, pa=True), ("pod_affinity", "pod_affinity")),
    (dict(nodes=1 << 16, queues=1 << 15), (None, "segment_key_overflow")),
    (dict(nodes=(1 << 16) - 2, queues=(1 << 15) - 1), (None, None)),
    (dict(nodes=100, queues=8, groups=1 << 16, tasks=1 << 15), ("no_canon_pack",) * 2),
])
def test_fallback_reasons_match_reference(case, want):
    ref_st, port_st = _stub(**case)
    no_preds = [
        (mod.Tier(plugins=tuple(mod.PluginOption.of(n) for n in ("gang", "proportion"))),)
        for mod in (ref_ord, port_ord)
    ]
    for ref_tiers, port_tiers in ((REF_TIERS, TIERS), no_preds):
        got = (port_pre.reclaim_batch_fallback_reason(port_st, port_tiers),
               port_pre.reclaim_engine_fallback_reason(port_st, port_tiers))
        exp = (ref_pre.reclaim_batch_fallback_reason(ref_st, ref_tiers),
               ref_pre.reclaim_engine_fallback_reason(ref_st, ref_tiers))
        assert got == exp
        if ref_tiers is REF_TIERS:
            assert got == want
        elif case.get("pa"):
            assert got == (None, None)  # pod affinity binds only with predicates on


# ---------------------------------------------------------------- the cycle


def test_staged_cycle_matches_reference_and_schedule_cycle():
    """``schedule_cycle_staged`` under ``reclaim_optimistic``: the stage
    names and counters equal the reference's staged runner, its
    decisions equal the reference's and the port's ``schedule_cycle``."""
    st = _synth(2000, 200, 8, 2, 0.5)
    pst = from_numpy(pack_arrays(st), "cpu")
    ref_dec, ref_t = ref_cycle.schedule_cycle_staged(st, actions=EVICTIVE)
    dec, timings = port_cycle.schedule_cycle_staged(pst, actions=EVICTIVE)
    assert [x[0] for x in timings] == [x[0] for x in ref_t] == ["open_session", *EVICTIVE, "commit"]
    assert [x[3:] for x in timings] == [x[3:] for x in ref_t]
    assert all(len(x) == 6 and x[2] >= 0.0 for x in timings)
    assert timings[1][5] > 0  # the optimistic engine discarded speculation
    assert_decisions_equal(ref_dec, dec)
    stats = {}
    plain = port_cycle.schedule_cycle(pst, actions=EVICTIVE, stats=stats)
    for f in dataclasses.fields(plain):
        assert torch.equal(getattr(plain, f.name), getattr(dec, f.name)), f.name
    assert stats["rounds.reclaim_optimistic"] == timings[1][3]
    assert stats["rounds_gated.reclaim_optimistic"] == timings[1][4]
    assert stats["claim_conflicts.reclaim_optimistic"] == timings[1][5]
    assert stats["rounds_gated.preempt"] == timings[4][4]
    with pytest.raises(ValueError, match="unknown action: reclaim_turbo"):
        port_cycle.schedule_cycle_staged(pst, actions=("reclaim_turbo",))


def test_staged_cycle_reports_a_fallback_once(capsys):
    """An evictive action whose fast engine the pack cannot take is named
    once per (action, reason) on stderr, in the reference's words."""
    st0 = build_snapshot(_two_queue_world().cluster).tensors
    pst = from_numpy(_stripped(pack_arrays(st0)), "cpu")
    port_cycle._FALLBACKS_SEEN.discard(("reclaim_optimistic", "no_canon_pack"))
    for _ in range(2):
        port_cycle.schedule_cycle_staged(pst, actions=("reclaim_optimistic",))
    err = capsys.readouterr().err
    line = ("# kat: reclaim_optimistic fast-path engine disabled for this pack shape "
            "(reason=no_canon_pack); running the default reclaim dispatch")
    assert err.count(line) == 1


# ---------------------------------------------------------------- K13-K16


def _canon_midway(st, claims_wanted=2):
    """The port's canon state after the sequential walk's first claims
    under the default tiers (gang decides reclaim), turn by turn."""
    (sess, state), pst, (psess, pstate) = _both(st)
    use_gang, use_prop, preds_on = port_pre._reclaim_flags(TIERS)
    pstate = port_alloc._copy(pstate)
    ctx = port_pre._canon_ctx(pst, psess)
    carry = port_pre._canon_seed(pst, pstate, ctx)
    pstate.progress = torch.zeros((), dtype=torch.bool)
    nq, perm = port_pre._canon_round_order(pst, psess, TIERS, pstate, carry)
    i32 = torch.int32
    for qi in range(int(nq)):
        q = perm[qi:qi + 1]
        shared = port_pre._reclaim_shared(pst, psess, pstate, TIERS, carry.job_consumed)
        j, g, has_grp, req, pop, burn = port_pre._reclaim_pop(pst, psess, pstate, TIERS, shared,
                                                              q, carry.q_entries[q])
        pick = port_pre.canon_pick(pst, ctx, carry.cand, carry.rank_nj, carry.cum_nq,
                                   pstate.job_ready_cnt, psess.min_avail, pstate.queue_alloc,
                                   pstate.node_ports, pstate.node_num_tasks, q.to(i32),
                                   g.to(i32), has_grp, pop, req, use_gang, use_prop, preds_on)
        port_pre.canon_commit(pst, ctx, pstate, carry, pick, q.to(i32), j.to(i32), g.to(i32),
                              has_grp, pop, burn, req, use_gang, use_prop)
        if int(carry.n_claims[0]) >= claims_wanted:
            break
    assert int(carry.n_claims[0]) >= 1
    return pst, psess, pstate, ctx, carry


def _ref_ctx_state(st, pstate, carry):
    """The reference's canon context and the port's carried state as
    jnp arrays."""
    sess, state = _ref_open(st)
    ctx = ref_pre._canon_ctx(st, sess)
    rstate = dataclasses.replace(state, **{
        f: jnp.asarray(getattr(pstate, f).numpy()) for f in FIELDS + ("node_idle",)})
    return sess, ctx, rstate, jnp.asarray(carry.cand.numpy()), \
        jnp.asarray(carry.rank_nj.numpy()), jnp.asarray(carry.cum_nq.numpy())


@pytest.mark.parametrize("use_prop", [False, True])
def test_round_products_plain_matches_reference(use_prop):
    """K13's plain version (through the engines' ``RoundProductsPlan``:
    elig, per-node sums, segmented scan) from a state with claims behind
    it, bit for bit, under gang's verdict alone and with proportion's
    too."""
    st = _synth(4000, 400, 8, 3, 0.5)
    pst, psess, pstate, ctx, carry = _canon_midway(st)
    sess, rctx, rstate, cand, rank_nj, cum_nq = _ref_ctx_state(st, pstate, carry)
    want = jax.jit(lambda st_, se, cx, *a: ref_pre._round_products(
        st_, se, cx, True, use_prop, False, *a))(st, sess, rctx, rstate, cand, rank_nj, cum_nq)
    plan = port_pre._products_plan(pst, psess, pstate, ctx, carry, True, use_prop)
    got = plan()
    for name, a, b in zip(("elig", "pn", "segcum"), want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    assert use_prop or int(got[0].sum()) > 0
    # a clear dirty flag leaves the products alone
    kept = tuple(x.clone() for x in got)
    carry.cand.zero_()
    plan(torch.zeros(1, dtype=torch.bool))
    assert all(torch.equal(a, b) for a, b in zip(kept, got))


def test_union_minus_own_search_edges():
    """K14's subtraction on a hand-made key array: a node with no
    victims, a queue with no segment on a node, queue Q-1 on node N-1,
    and the padding sentinel, against ``_union_minus_own``."""
    rng = np.random.default_rng(4)
    N, Q, R = 12, 5, 4
    segs = sorted({(n, q) for n in range(N - 1) if n != 3 for q in rng.choice(Q, 2)}
                  | {(N - 1, Q - 1), (0, 0)})
    keys, seg_start = [], []
    for n, q in segs:
        ln = int(rng.integers(1, 4))
        keys += [n * (Q + 1) + q] * ln
        seg_start += [True] + [False] * (ln - 1)
    V = len(keys)
    Vp = V + 7
    skey = np.array(keys + [N * (Q + 1) + Q] * 7, np.int32)
    segcum = rng.integers(1, 50, (Vp, R + 1)).astype(np.float32)
    pn = rng.integers(50, 100, (N, R + 1)).astype(np.float32)
    qs = np.arange(Q)
    cnt, res = k14.union_minus_own(t(skey), t(segcum), t(pn), torch.from_numpy(qs), Q)
    nd_keys = jnp.arange(N, dtype=jnp.int32) * (Q + 1)
    rctx = types.SimpleNamespace(skey=jnp.asarray(skey))
    for q in qs:
        rc, rr = ref_pre._union_minus_own(rctx, nd_keys, jnp.asarray(segcum), jnp.asarray(pn),
                                          jnp.int32(q), Vp)
        assert np.array_equal(np.asarray(rc), cnt[q].numpy()), q
        assert np.array_equal(np.asarray(rr), res[q].numpy()), q
    # node 3 has no segment, node N-1 only queue Q-1's: nothing subtracted
    assert torch.equal(cnt[:, 3], t(pn[3, 0]).expand(Q))
    assert torch.equal(cnt[:Q - 1, N - 1], t(pn[N - 1, 0]).expand(Q - 1))
    assert cnt[Q - 1, N - 1] != pn[N - 1, 0]


def test_union_fit_plain_matches_reference_first_fit():
    """K14's plain version over every queue of a state with claims behind
    it: the first node of the reference's ``_union_minus_own`` +
    ``_fit_feasible`` (N where none)."""
    st = _synth(4000, 400, 8, 3, 0.5)
    pst, psess, pstate, ctx, carry = _canon_midway(st)
    sess, rctx, rstate, cand, rank_nj, cum_nq = _ref_ctx_state(st, pstate, carry)
    products = port_pre._products_plan(pst, psess, pstate, ctx, carry, True, False)
    prods = products()
    Vp = ctx.cres.shape[0]
    Q, N = pst.num_queues, pst.num_nodes
    shared = port_pre._reclaim_shared(pst, psess, pstate, TIERS, carry.job_consumed)
    q_ids = torch.arange(Q)
    j, g, has_grp, req, pop, burn = port_pre.reclaim_select_turns(
        pst, psess, pstate, TIERS, shared, q_ids, carry.q_entries)
    # every queue's pop as selected, again with requests no node's victims
    # cover, and once without a pop; the first 40 nodes' union counts
    # cleared, so the subtraction leaves them no victim
    q_rows = q_ids.repeat(3)
    g, has_grp, pop = g.repeat(3), has_grp.repeat(3), pop.repeat(3)
    req = torch.cat([req, req, req + 1e6])
    pop[Q:2 * Q] = False
    prods[1][:40, 0] = 0.0
    pick = port_pre._fit_plan(pst, pstate, ctx, products, True, 3 * Q)(
        q_rows.to(torch.int32), g.to(torch.int32), has_grp, pop, req)
    nd_keys = jnp.arange(N, dtype=jnp.int32) * (Q + 1)
    pn, segcum = jnp.asarray(prods[1].numpy()), jnp.asarray(prods[2].numpy())

    @jax.jit
    def ref_pick(st_, rs, cx, q, g_, hg, rq, pp):
        vc, vr = ref_pre._union_minus_own(cx, nd_keys, segcum, pn, q, Vp)
        feas = ref_pre._fit_feasible(st_, rs, True, g_, hg, rq, pp, vc, vr)
        return jnp.where(jnp.any(feas), jnp.argmin(jnp.where(feas, jnp.arange(N), N)), N)

    for r in range(3 * Q):
        want = ref_pick(st, rstate, rctx, jnp.int32(int(q_rows[r])), jnp.int32(int(g[r])),
                        jnp.bool_(bool(has_grp[r])), jnp.asarray(req[r].numpy()),
                        jnp.bool_(bool(pop[r])))
        assert int(pick[r]) == int(want), r
    assert (pick[Q:] == N).all() and (pick[:Q] >= 40).all() and (pick[:Q] < N).any()


def _ref_gate(pick, N, start, trip, q_panel, jp, popp, burnp, q_entries, job_consumed):
    """The reference's commit gate (preempt.py:2737-2800) in jnp."""
    RP = pick.shape[0]
    w_iota = jnp.arange(RP, dtype=jnp.int32)
    in_window = start + w_iota < trip
    claimed_spec = pick < N
    has_claim = jnp.any(claimed_spec)
    first = jnp.where(has_claim, jnp.argmax(claimed_spec).astype(jnp.int32), jnp.int32(RP))
    commit_mask = in_window & (w_iota < first)
    burn_or_fail = commit_mask & (burnp | popp)
    Q, J = q_entries.shape[0], job_consumed.shape[0]
    q_entries = q_entries.at[jnp.where(burn_or_fail, q_panel, Q)].add(-1, mode="drop")
    job_consumed = job_consumed.at[jnp.where(commit_mask & popp, jp, J)].set(True, mode="drop")
    progressed = jnp.any(commit_mask & popp)
    conflicts = jnp.sum((claimed_spec & (w_iota > first)).astype(jnp.int32))
    start_next = start + jnp.sum(commit_mask.astype(jnp.int32)) + has_claim.astype(jnp.int32)
    round_done = start_next >= trip
    gated = round_done & (start == 0) & ~has_claim
    return (q_entries, job_consumed, progressed, conflicts, jnp.where(round_done, 0, start_next),
            round_done, gated, has_claim, jnp.minimum(first, RP - 1))


@pytest.mark.parametrize("seed", range(6))
def test_window_gate_plain_matches_reference(seed):
    """K15's plain version against the reference's gate on seeded
    windows: a first window, a continuation window, one with no claim,
    one whose window runs past the round's trip."""
    rng = np.random.default_rng(seed)
    RP, Q, J, N, R = 16, 24, 40, 30, 4
    start = [0, 5, 0, 9, 0, 12][seed]
    trip = [16, 20, 7, 13, 24, 14][seed]
    perm = rng.permutation(Q).astype(np.int32)
    q_panel = perm[np.minimum(start + np.arange(RP), Q - 1)]
    popp = rng.random(RP) < 0.6
    burnp = ~popp & (rng.random(RP) < 0.7)
    jp = rng.permutation(J)[:RP].astype(np.int32)
    gp = rng.integers(0, 50, RP).astype(np.int32)
    pick = np.where((rng.random(RP) < [0.3, 0.3, 0.0, 0.2, 0.1, 0.5][seed]) & popp
                    & (start + np.arange(RP) < trip), rng.integers(0, N, RP), N).astype(np.int32)
    q_entries = rng.integers(1, 4, Q).astype(np.int32)
    job_consumed = rng.random(J) < 0.2
    reqp = rng.integers(0, 100, (RP, R)).astype(np.float32)
    hgp = popp | (rng.random(RP) < 0.5)
    want = _ref_gate(jnp.asarray(pick), N, jnp.int32(start), jnp.int32(trip),
                     jnp.asarray(q_panel), jnp.asarray(jp), jnp.asarray(popp), jnp.asarray(burnp),
                     jnp.asarray(q_entries), jnp.asarray(job_consumed))
    ctl, sel = k15.new_gate(R, "cpu")
    ctl[k15.START], ctl[k15.TRIP], ctl[k15.CONFLICTS] = start, trip, 3
    qe, jc = t(q_entries), t(job_consumed)
    progress = torch.zeros((), dtype=torch.bool)
    k15.window_gate(t(pick), N, t(q_panel), t(jp), t(gp), t(hgp), t(reqp), t(popp), t(burnp),
                    ctl, qe, jc, progress, sel)
    (wq, wj, wprog, wconf, wstart, wdone, wgated, whas, ws) = want
    assert np.array_equal(np.asarray(wq), qe.numpy())
    assert np.array_equal(np.asarray(wj), jc.numpy())
    assert bool(progress) == bool(wprog)
    assert int(ctl[k15.START]) == int(wstart) and int(ctl[k15.ROUND_DONE]) == int(wdone)
    assert int(ctl[k15.ROUNDS]) == int(wdone) and int(ctl[k15.GATED]) == int(wgated)
    assert int(ctl[k15.CONFLICTS]) == 3 + int(wconf) and int(ctl[k15.WINDOWS]) == 1
    s = int(ws)
    assert sel[0].tolist() == [q_panel[s], jp[s], gp[s], pick[s]]
    assert sel[1].tolist() == [hgp[s], popp[s], burnp[s], bool(whas)]
    assert torch.equal(sel[2], t(reqp[s]))


@pytest.mark.parametrize("cap", [1, 37, 200, 512])
def test_stable_compact_plain_matches_compact_indices(cap):
    """K16 in B7's mode: the commit's index lists, -1 padded, and the full
    count even past ``cap``."""
    rng = np.random.default_rng(cap)
    mask = rng.random(700) < 0.4
    want_idx, want_count = jax.jit(
        lambda m: ref_cycle._compact_indices(m, cap, False))(jnp.asarray(mask))
    idx, count = port_cycle._compact_indices(t(mask), cap)
    assert np.array_equal(np.asarray(want_idx), idx.numpy())
    assert int(want_count) == int(count) == int(mask.sum())
    assert idx.dtype == count.dtype == torch.int32 and count.dim() == 0
    if cap < mask.sum():
        assert (idx >= 0).all()


def test_stable_compact_plain_matches_compact_rows_and_cells():
    """K16 in B4's mode: the reference's ``_prune_feasible`` +
    ``_compact_rows`` (pad N), from the mask and from :class:`FeasCells`
    alike, with the full counts."""
    st = build_snapshot(generate_cluster(num_nodes=60, num_jobs=12, tasks_per_job=5,
                                         num_queues=3, seed=4, running_fraction=0.3)
                        .cluster).tensors
    (sess, state), pst, (psess, pstate) = _both(st)
    N = st.num_nodes
    for best_effort in (False, True):
        feas = ref_alloc._prune_feasible(st, state, REF_TIERS, best_effort)
        cells = port_alloc._prune_cells(pst, pstate, TIERS, best_effort)
        assert np.array_equal(np.asarray(feas), cells.mask().numpy())
        for NC in (N // 4, N // 2, N):
            want = np.asarray(ref_alloc._compact_rows(feas, NC))
            for src in (cells, cells.mask()):
                idx, count = port_alloc._compact_rows(src, NC)
                assert np.array_equal(want, idx.numpy()), (best_effort, NC)
                assert np.array_equal(np.asarray(feas).sum(1), count.numpy())


def test_stable_compact_plain_matches_build_view():
    """K16 in B11's mode: preempt's victim panel (pad T, ``valid`` is
    idx < T) equals the reference's ``_build_view``."""
    st = build_snapshot(generate_cluster(num_nodes=20, num_jobs=16, tasks_per_job=10,
                                         num_queues=4, seed=6, running_fraction=0.5)
                        .cluster).tensors
    (sess, state), pst, (psess, pstate) = _both(st)
    T = st.num_tasks
    running0 = (state.task_status == int(TaskStatus.RUNNING)) & st.task_valid & (state.task_node >= 0)
    for P in (T // 4, T // 2):
        qualify = np.asarray(running0) & (np.arange(T) % 3 != 0)
        if qualify.sum() > P:
            continue
        view = jax.jit(lambda st_, s, r: ref_pre._build_view(st_, s, r, P))(
            st, state, jnp.asarray(qualify))
        pview = port_pre._build_view(pst, pstate, t(qualify), P)
        for f in ("idx", "valid", "job", "queue", "node", "priority", "resreq"):
            assert np.array_equal(np.asarray(getattr(view, f)), getattr(pview, f).numpy()), (P, f)
        assert int(pview.valid.sum()) == int(qualify.sum()) > 0


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("queues", [8, 64])
def test_engines_on_card_match_cpu(cuda_device, queues):
    """K13-K16 through the opt-in engines and the ``reclaim_optimistic``
    cycle: the card decides like the CPU, counters included."""
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays

    arrays, _ = build_synthetic_arrays(4000, 400, num_queues=queues, tasks_per_job=20, seed=1,
                                       running_fraction=0.5, fit_fraction=1.25)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        pst = from_numpy(arrays, dev)
        sess, state = port_cycle.open_session(pst, TIERS)
        out[dev.type] = [port_pre.reclaim_action(pst, sess, state, TIERS, turn_batch=tb)
                         for tb in (True, "optimistic")]
        out[dev.type].append(port_cycle.schedule_cycle(pst, actions=EVICTIVE))
    for a, b in zip(out["cuda"], out["cpu"]):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            same = torch.equal(x.cpu(), y) if isinstance(y, torch.Tensor) else x == y
            assert same, f.name
