"""The plain versions of the port's kernels held against their JAX
counterparts, the ctypes bindings against the CUDA sources, and (on a
GPU only) each kernel against its plain version.

Inputs are made with numpy from a seed and handed to both sides.  Every
comparison is exact (tolerance: none): the plain versions repeat the
reference's arithmetic operation for operation, and K4 / K5 add in slot
order like the reference's sequential scatter and native scan (at
integer-valued inputs the reference's jnp tree scan gives the same bits).
"""
import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.api import TaskStatus
from kube_arbitrator_tpu.cache import build_snapshot, generate_cluster
from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import allocate as ref_alloc
from kube_arbitrator_tpu.ops import common as ref_common
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord_mod
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu.ops.ordering import DEFAULT_TIERS as REF_TIERS
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import common as port_common
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import admit_chunk as k1
from kube_arbitrator_tpu_torch.ops.kernels import build
from kube_arbitrator_tpu_torch.ops.kernels import canon_commit as k8
from kube_arbitrator_tpu_torch.ops.kernels import canon_pick as k7
from kube_arbitrator_tpu_torch.ops.kernels import claim_nodes as k6
from kube_arbitrator_tpu_torch.ops.kernels import decode_deferred as k3
from kube_arbitrator_tpu_torch.ops.kernels import lex_argmin as k2
from kube_arbitrator_tpu_torch.ops.kernels import ordered_scan as k20
from kube_arbitrator_tpu_torch.ops.kernels import pa_fit as k11
from kube_arbitrator_tpu_torch.ops.kernels import pa_shape as k12
from kube_arbitrator_tpu_torch.ops.kernels import queue_order as k17
from kube_arbitrator_tpu_torch.ops.kernels import round_products as k13
from kube_arbitrator_tpu_torch.ops.kernels import row_scatter as k18
from kube_arbitrator_tpu_torch.ops.kernels import seg_scan as k5
from kube_arbitrator_tpu_torch.ops.kernels import segment_sum as k4
from kube_arbitrator_tpu_torch.ops.kernels import stable_compact as k16
from kube_arbitrator_tpu_torch.ops.kernels import stable_sort as k19
from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9
from kube_arbitrator_tpu_torch.ops.kernels import turn_fill as k10
from kube_arbitrator_tpu_torch.ops.kernels import union_fit as k14
from kube_arbitrator_tpu_torch.ops.kernels import window_gate as k15
from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as PORT_TIERS

GB = 1024**3


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- K1


def test_node_capacity_matches_reference_on_fractional_inputs():
    rng = np.random.default_rng(0)
    M, R = 4096, 4
    avail = rng.uniform(-50, 9000, (M, R)).astype(np.float32)
    pods = rng.integers(-2, 30, M).astype(np.int32)
    ok = rng.random(M) < 0.9
    for trial in range(6):
        req = (rng.uniform(0.5, 3000, R) * (rng.random(R) < 0.7)).astype(np.float32)
        single = trial % 2 == 1
        want = np.asarray(ref_alloc._node_capacity(
            jnp.asarray(avail), jnp.asarray(req), jnp.asarray(ok), jnp.asarray(pods),
            jnp.asarray(single),
        ))
        got = k1.node_capacity(t(avail), t(req), t(ok), t(pods), single).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f"trial {trial}"


def test_to_i32_saturates_like_xla():
    x = np.array([0.0, -0.7, 2.9, 3e9, -3e9, 2147483520.0, np.nan, np.inf, -np.inf], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    assert np.array_equal(k1.to_i32(t(x)).numpy(), want)


def _round_world(seed):
    return generate_cluster(
        num_nodes=48, num_jobs=14, tasks_per_job=6, num_queues=4, seed=seed,
        node_cpu_milli=4000, node_memory=8 * GB, running_fraction=0.3,
    )


_ref_round = jax.jit(ref_alloc._round_batched, static_argnums=(3, 4, 5))

ROUND_FIELDS = (
    "node_idle", "node_releasing", "node_ports", "node_num_tasks", "job_alloc",
    "queue_alloc", "job_ready_cnt", "group_placed", "group_unfit",
)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pruned", [False, True])
def test_round_matches_reference_slot_body(seed, pruned):
    """One batched round on both sides from the same state: the slot body
    (K1's plain version) must leave identical node state, [G, N] counts
    and per-slot aggregates, full width and through a pruned panel."""
    st = build_snapshot(_round_world(seed).cluster).tensors
    pst = from_numpy(pack_arrays(st), "cpu")
    sess, state = ref_cycle.open_session(st, REF_TIERS)
    psess, pstate = port_cycle.open_session(pst, PORT_TIERS)
    G, N, Q = pst.num_groups, pst.num_nodes, pst.num_queues
    panel = pan = None
    if pruned:
        feas = ref_alloc._prune_feasible(st, state, REF_TIERS, False)
        panel = ref_alloc._compact_rows(feas, N // 2)
        pan = t(np.asarray(panel))
    trip = int(np.asarray(st.queue_valid).sum())
    gn = (jnp.zeros((G, N), jnp.int32), jnp.zeros((G, N), jnp.int32),
          jnp.array(False), jnp.array(False))
    pgn = (torch.zeros((G, N), dtype=torch.int32), torch.zeros((G, N), dtype=torch.int32),
           torch.tensor(False), torch.tensor(False))
    admit = k1.AdmitPlan(pst, pstate.node_idle, pstate.node_releasing, pstate.node_ports,
                         pstate.node_num_tasks, pgn[0], pgn[1], pan, 4096, False, True,
                         port_alloc.TURN_CHUNK)
    for _ in range(3):
        state = dataclasses.replace(state, progress=jnp.array(False))
        pstate.progress = torch.tensor(False)
        state, gn = _ref_round(
            st, sess, state, REF_TIERS, 4096, False, gn, jnp.arange(Q), jnp.int32(trip),
            prune_idx=panel,
        )
        pgn = port_alloc._round_batched(
            pst, psess, pstate, PORT_TIERS, 4096, False, pgn, torch.arange(Q), trip, admit,
        )
        for f in ROUND_FIELDS:
            assert np.array_equal(np.asarray(getattr(state, f)), getattr(pstate, f).numpy()), f
        for a, b in zip(gn, pgn):
            assert np.array_equal(np.asarray(a), b.numpy())
    assert int(pgn[0].sum()) > 0


# ---------------------------------------------------------------- K2


def test_lex_argmin_matches_reference():
    """K2's filter (the plan's plain version) against the reference's
    ``lex_argmin`` on free key columns and masks, and through
    ``TurnPickPlan``: rows are queues whose job columns (-priority, the
    DRF share with entries at BIG, the creation rank) hold the same
    kind of values, against the reference over the same columns."""
    rng = np.random.default_rng(2)
    K, M, S = 4, 300, 9
    keys = rng.integers(0, 3, (K, M)).astype(np.float32)
    keys[1] = np.where(rng.random(M) < 0.3, 3.0e38, rng.random(M)).astype(np.float32)
    keys[2] = (rng.integers(0, 4, M) * 0.1).astype(np.float32)
    mask = rng.random((S, M)) < 0.2
    mask[4] = False
    mask[7] = True
    for k in (keys, keys[:2]):
        want_i, want_a = ref_common.lex_argmin([jnp.asarray(c) for c in k], jnp.asarray(mask))
        got_i, got_a = k2.lex_argmin_plain(t(k.copy()), t(mask))
        assert np.array_equal(got_i.numpy(), np.asarray(want_i).astype(np.int32))
        assert np.array_equal(got_a.numpy(), np.asarray(want_a))
    # through the plan: tiers (priority, drf), S queues
    tiers = [m.Tier(plugins=(m.PluginOption.of("priority"), m.PluginOption.of("drf")))
             for m in (ref_ord_mod, port_ord)]
    prio = -keys[0].astype(np.int32)
    rank = keys[3].astype(np.int32)
    share = keys[1]
    job_queue = (np.arange(M) % S).astype(np.int32)
    pending = rng.random(M) < 0.8
    pending[job_queue == 4] = False
    G = M
    st = types.SimpleNamespace(
        job_queue=t(job_queue), job_valid=t(np.ones(M, bool)), group_job=t(np.arange(G, dtype=np.int32)),
        job_priority=t(prio), job_creation_rank=t(rank), group_priority=t(np.zeros(G, np.int32)),
        group_uid_rank=t(np.arange(G, dtype=np.int32)))
    plan = k2.TurnPickPlan(st, (tiers[1],))
    q = np.arange(S, dtype=np.int64)
    ready = np.zeros(M, bool)
    got_j, got_a, _, _, got_mask = plan.select(t(q), t(np.ones(S, bool)), t(pending), t(ready),
                                               t(share), t(np.ones(G, bool)), jmask=True)
    jkeys = ref_ord_mod.job_order_keys((tiers[0],), jnp.asarray(prio), jnp.asarray(ready),
                                       jnp.asarray(rank), jnp.asarray(share))
    jmask = (job_queue[None, :] == q[:, None]) & pending[None, :]
    want_i, want_a = ref_common.lex_argmin([c[None, :] for c in jkeys], jnp.asarray(jmask))
    assert np.array_equal(got_j.numpy(), np.asarray(want_i))
    assert np.array_equal(got_a.numpy(), np.asarray(want_a))
    assert np.array_equal(got_mask.numpy(), jmask)


# ---------------------------------------------------------------- K3


@pytest.mark.parametrize("with_pipelined", [False, True])
def test_decode_matches_reference(with_pipelined):
    snap = ref_synth(num_tasks=600, num_nodes=40, num_queues=2, tasks_per_job=30, seed=5,
                     running_fraction=0.2)
    st = snap.tensors
    _, state = ref_cycle.open_session(st, REF_TIERS)
    rng = np.random.default_rng(3)
    G, N = st.num_groups, st.num_nodes
    size = np.asarray(st.group_size)
    entry = rng.integers(0, 4, G).astype(np.int32)
    gn = []
    for lim in (size, size // 3):
        c = np.zeros((G, N), np.int32)
        tot = np.minimum(rng.integers(0, 40, G), lim)
        rows = np.repeat(np.arange(G), tot)
        np.add.at(c, (rows, rng.integers(0, N, rows.shape[0])), 1)
        gn.append(c)
    gn_p = gn[1] if with_pipelined else np.zeros_like(gn[1])
    want = ref_alloc._decode_deferred(
        st, state, jnp.asarray(entry), jnp.asarray(gn[0]), jnp.asarray(gn_p),
        jnp.asarray(with_pipelined),
    )
    status, node = t(np.asarray(state.task_status)), t(np.asarray(state.task_node))
    plan = k3.DecodePlan(
        t(gn[0]), t(gn_p) if with_pipelined else None, t(np.asarray(st.task_group)),
        t(np.asarray(st.task_group_rank)), t(np.asarray(st.task_valid)), t(entry), status, node,
    )
    plan(torch.tensor(True), torch.tensor(with_pipelined))  # in place
    assert np.array_equal(status.numpy(), np.asarray(want.task_status))
    assert np.array_equal(node.numpy(), np.asarray(want.task_node))
    assert (status.numpy() == 1).sum() > 100


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("cols", [0, 4])
def test_segment_sum_matches_reference_scatter_order(cols):
    """Non-integer f32 values with many duplicates: only slot order gives
    the reference's bits.  Indices past the end are dropped by both."""
    rng = np.random.default_rng(4)
    T, S = 5000, 37
    shape = (T,) if cols == 0 else (T, cols)
    val = (rng.standard_normal(shape) * 1e3).astype(np.float32) + np.float32(0.1)
    idx = rng.integers(0, S + 3, T).astype(np.int32)
    want = np.asarray(jnp.zeros((S,) + shape[1:], jnp.float32).at[idx].add(val))
    got = k4.segment_sum(t(val), t(idx), S).numpy()
    assert np.array_equal(got, want)
    # the reverse order does not give these bits: the test pins the order
    keep = idx[::-1] < S
    rev = np.zeros_like(want)
    np.add.at(rev, idx[::-1][keep], val[::-1][keep])
    assert not np.array_equal(rev, want)
    ival = rng.integers(-100, 100, shape).astype(np.int32)
    want_i = np.asarray(jnp.zeros((S,) + shape[1:], jnp.int32).at[idx].add(ival))
    assert np.array_equal(k4.segment_sum(t(ival), t(idx), S).numpy(), want_i)


def test_segment_sum_drops_negative_indices_and_orders_long_runs():
    rng = np.random.default_rng(6)
    val = (rng.standard_normal((3000, 2)) * 7).astype(np.float32)
    idx = rng.integers(-2, 3, 3000).astype(np.int32)
    want = np.zeros((3, 2), np.float32)
    for i in range(3000):  # the sequential scatter, slot by slot
        if 0 <= idx[i] < 3:
            want[idx[i]] = want[idx[i]] + val[i]
    assert np.array_equal(k4.segment_sum(t(val), t(idx), 3).numpy(), want)
    seq = np.float32(0)
    for v in val[:, 0]:
        seq = np.float32(seq + v)
    assert k4.ordered_sum(t(val[:, 0].copy())).item() == seq


def test_segment_sum_accumulates_into_out_in_slot_order():
    """``out=``: the reference's ``base.at[idx].add(val)``, the base's own
    value first, then the slots in order."""
    rng = np.random.default_rng(7)
    val = (rng.standard_normal((2000, 3)) * 1e3).astype(np.float32)
    idx = rng.integers(-1, 12, 2000).astype(np.int32)
    base = (rng.standard_normal((11, 3)) * 1e6).astype(np.float32)
    want = np.asarray(jnp.asarray(base).at[jnp.where(idx >= 0, idx, 11)].add(val, mode="drop"))
    out = t(base)
    assert k4.segment_sum(t(val), t(idx), 11, out=out) is out
    assert np.array_equal(out.numpy(), want)


# ---------------------------------------------------------------- K5


def _layout_inputs(rng, P, n_seg, integral):
    seg = rng.integers(0, n_seg, P).astype(np.int32)
    seg2 = rng.integers(0, 5, P).astype(np.int32)
    prio = rng.integers(0, 4, P).astype(np.int32)
    uid = rng.permutation(P).astype(np.int32)
    res = rng.integers(0, 5000, (P, 4)).astype(np.float32)
    if not integral:
        res = res * np.float32(0.37)
    return seg, seg2, prio, uid, res


@pytest.mark.parametrize("composite", [False, True])
def test_seg_scan_matches_rank_and_cum(composite):
    """K5's plain version against ``SortLayout.rank_and_cum`` (the jnp
    tree scan: integer-valued resreqs, so every order agrees)."""
    rng = np.random.default_rng(12)
    P = 3000
    seg, seg2, prio, uid, res = _layout_inputs(rng, P, 40, integral=True)
    keys = (seg2, seg) if composite else (seg,)
    port = port_pre.SortLayout.build(
        tuple(t(k) for k in keys) if composite else t(seg), t(prio), t(uid), t(res))

    @jax.jit
    def ref_scan(mask):
        jk = tuple(jnp.asarray(k) for k in keys)
        lay = ref_pre.SortLayout.build(jk if composite else jk[0], jnp.asarray(prio),
                                       jnp.asarray(uid), jnp.asarray(res))
        return lay.rank_and_cum(mask)

    for frac in (0.0, 0.3, 1.0):
        mask = rng.random(P) < frac
        want_rank, want_cum = ref_scan(jnp.asarray(mask))
        rank, cum = port.rank_and_cum(t(mask))
        assert np.array_equal(rank.numpy(), np.asarray(want_rank))
        assert np.array_equal(cum.numpy(), np.asarray(want_cum))


def test_seg_cumsum_is_the_serial_order():
    """Fractional values: ``seg_cumsum`` adds serially within a segment
    (the reference's native ``kat_seg_cumsum_f32`` order), and at integer
    values it equals the reference's jnp ``seg_cumsum``."""
    rng = np.random.default_rng(13)
    V = 2500
    x = (rng.standard_normal((V, 3)) * 1e5).astype(np.float32)
    start = rng.random(V) < 0.05
    want = np.empty_like(x)
    acc = np.zeros(3, np.float32)
    for i in range(V):
        acc = x[i].copy() if (i == 0 or start[i]) else (acc + x[i]).astype(np.float32)
        want[i] = acc
    assert np.array_equal(port_common.seg_cumsum(t(x), t(start)).numpy(), want)
    xi = np.round(x[:, 0] / 1e3).astype(np.float32)
    assert np.array_equal(port_common.seg_cumsum(t(xi), t(start)).numpy(),
                          np.asarray(jax.jit(ref_common.seg_cumsum)(jnp.asarray(xi), jnp.asarray(start))))


# ---------------------------------------------------------------- K6


def _claim_world():
    return generate_cluster(
        num_nodes=24, num_jobs=16, tasks_per_job=6, num_queues=3, seed=4,
        node_cpu_milli=4000, node_memory=8 * GB, running_fraction=0.5,
    )


@pytest.mark.parametrize("mode", ["preempt", "preempt_intra"])
def test_claim_turns_match_reference(mode):
    """K6's plain version (with the K4 / K5 glue around it): the port's
    sequential preempt turn, queue after queue, against the reference's
    ``_claim_turn`` / ``_apply_claim`` from the same state."""
    st = build_snapshot(_claim_world().cluster).tensors
    pst = from_numpy(pack_arrays(st), "cpu")
    sess, state = ref_cycle.open_session(st, REF_TIERS)
    psess, pstate = port_cycle.open_session(pst, PORT_TIERS)
    T = st.num_tasks
    running0 = (state.task_status == int(TaskStatus.RUNNING)) & st.task_valid & (state.task_node >= 0)
    view = jax.jit(lambda st_, s, r: ref_pre._build_view(st_, s, r, T))(st, state, running0)
    pview = port_pre._build_view(pst, pstate, t(np.asarray(running0)), T)
    turn = jax.jit(lambda st, se, s, q: ref_pre._claim_turn(q, st, se, s, REF_TIERS, 4096, mode, view))
    fields = ("task_status", "task_node", "evicted_for", "job_alloc", "queue_alloc",
              "job_ready_cnt", "group_placed", "group_unfit", "node_releasing",
              "node_num_tasks", "node_ports", "evict_claimant", "evict_phase")
    claim = port_pre._claim_plan(pst, PORT_TIERS, pview, 4096, mode)  # K6, as a round loop binds it
    for q in list(range(3)) * 2:
        state = turn(st, sess, state, jnp.int32(q))
        port_pre._claim_turn(torch.tensor([q]), pst, psess, pstate, PORT_TIERS, 4096, mode, pview,
                             claim)
        for f in fields:
            assert np.array_equal(np.asarray(getattr(state, f)), getattr(pstate, f).numpy()), (q, f)
    if mode == "preempt":
        assert (pstate.evicted_for.numpy() >= 0).sum() > 0


# ---------------------------------------------------------------- K7, K8


def _ref_canon_turn(st, sess, tiers, ctx, state, q_entries, job_consumed, cand, evicted_c,
                    rank_nj, cum_nq, log_g, log_n, log_r, n_claims, q):
    """One turn of the reference's ``_reclaim_canon`` (:2323-2346), with
    its node pick exposed."""
    W = st.rv_window
    shared = ref_pre._reclaim_shared(st, sess, state, tiers, job_consumed)
    j, g, has_grp, req, pop, burn_now = ref_pre._reclaim_pop(
        st, sess, state, tiers, shared, q, q_entries[q])
    elig = ref_pre._canon_elig(sess, state, ctx, cand, rank_nj, cum_nq, True, False)
    mask_v = elig & (ctx.cq != q)
    per_node = ref_pre._canon_per_node(st, ctx, mask_v, False)
    feas = ref_pre._fit_feasible(st, state, True, g, has_grp, req, pop, per_node[:, 0],
                                 per_node[:, 1:])
    pick = jnp.where(jnp.any(feas), jnp.argmin(jnp.where(feas, jnp.arange(st.num_nodes),
                                                         st.num_nodes)), st.num_nodes)
    out, _ = ref_pre._canon_fit_commit(
        st, sess, tiers, ctx, True, True, False, state, q_entries, job_consumed, cand,
        evicted_c, rank_nj, cum_nq, log_g, log_n, log_r, n_claims,
        q, j, g, has_grp, req, pop, burn_now, per_node[:, 0], per_node[:, 1:],
        lambda start: jax.lax.dynamic_slice(mask_v, (start,), (W,)),
    )
    return out, pick


def test_canon_turns_match_reference():
    """K7's and K8's plain versions: every reclaim turn's node pick (the
    reference's per-node sums + ``_fit_feasible`` + first fit) and window
    commit against ``_canon_fit_commit``, carry and state alike."""
    st = build_snapshot(_claim_world().cluster).tensors
    pst = from_numpy(pack_arrays(st), "cpu")
    sess, state = ref_cycle.open_session(st, REF_TIERS)
    psess, pstate = port_cycle.open_session(pst, PORT_TIERS)
    ctx, seed = jax.jit(lambda st_, se, s: (
        ref_pre._canon_ctx(st_, se), ref_pre._canon_seed(st_, s, ref_pre._canon_ctx(st_, se))
    ))(st, sess, state)
    cand, rank_nj, cum_nq, q_entries, (log_g, log_n, log_r, n_claims) = seed
    job_consumed = jnp.zeros(st.num_jobs, bool)
    evicted_c = jnp.zeros(st.rv_idx.shape[0], bool)
    pctx = port_pre._canon_ctx(pst, psess)
    pstate.progress = torch.zeros((), dtype=torch.bool)
    carry = port_pre._canon_seed(pst, pstate, pctx)
    turn = jax.jit(lambda st_, *a: _ref_canon_turn(st_, sess, REF_TIERS, ctx, *a))
    J = st.num_jobs
    claims = 0
    for q in list(range(3)) * 3:
        out, pick = turn(st, state, q_entries, job_consumed, cand, evicted_c, rank_nj, cum_nq,
                         log_g, log_n, log_r, n_claims, jnp.int32(q))
        (state, q_entries, job_consumed, cand, evicted_c, rank_nj, cum_nq,
         log_g, log_n, log_r, n_claims) = out
        qt = torch.tensor([q])
        shared = port_pre._reclaim_shared(pst, psess, pstate, PORT_TIERS, carry.job_consumed)
        j, g, has_grp, req, pop, burn_now = port_pre._reclaim_pop(
            pst, psess, pstate, PORT_TIERS, shared, qt, carry.q_entries[qt])
        i32 = torch.int32
        ppick = k7.canon_pick(pst, pctx, carry.cand, carry.rank_nj, carry.cum_nq,
                              pstate.job_ready_cnt, psess.min_avail, pstate.queue_alloc,
                              pstate.node_ports, pstate.node_num_tasks, qt.to(i32), g.to(i32),
                              has_grp, pop, req, True, False, True)
        assert int(ppick) == int(pick), q
        k8.canon_commit(pst, pctx, pstate, carry, ppick, qt.to(i32), j.to(i32), g.to(i32),
                        has_grp, pop, burn_now, req, True, False)
        for name, a, b in (
            ("cand", cand, carry.cand), ("evicted_c", evicted_c, carry.evicted_c),
            ("rank_nj", rank_nj, carry.rank_nj), ("cum_nq", cum_nq, carry.cum_nq),
            ("q_entries", q_entries, carry.q_entries),
            ("job_consumed", job_consumed, carry.job_consumed),
            ("log_g", log_g, carry.log_g[:J]), ("log_n", log_n, carry.log_n[:J]),
            ("log_r", log_r, carry.log_r[:J]), ("n_claims", n_claims, carry.n_claims[0]),
        ):
            assert np.array_equal(np.asarray(a), b.numpy()), (q, name)
        for f in ("job_alloc", "queue_alloc", "job_ready_cnt", "group_placed", "node_releasing",
                  "node_ports", "node_num_tasks", "evict_claimant", "evict_phase", "evict_round"):
            assert np.array_equal(np.asarray(getattr(state, f)), getattr(pstate, f).numpy()), (q, f)
        claims = int(n_claims)
    assert claims > 0


# ---------------------------------------------------------------- bindings


def _c_signatures():
    """extern "C" function name -> ctypes types, parsed from csrc/*.cu."""
    out = {}
    for src in build.CSRC.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = (src.stem, tuple(build.P if "*" in p else build.I for p in params))
    return out


def test_ctypes_bindings_match_c_signatures():
    sigs = _c_signatures()
    declared = {}
    for mod in (k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11, k12, k13, k14, k15, k16, k17, k18,
                k19, k20):
        declared.update(mod.SIGNATURES)
    assert set(declared) == set(sigs)
    for name, types in declared.items():
        assert sigs[name][1] == tuple(types), name
        assert sigs[name][0] in build.SOURCES
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}


def test_wrappers_count_launches_only_on_the_card():
    before = k4.segment_sum.launches
    k4.segment_sum(torch.ones(4), torch.zeros(4, dtype=torch.int32), 1)
    assert k4.segment_sum.launches == before


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda_device):
    rng = np.random.default_rng(9)
    val = torch.from_numpy((rng.standard_normal((4000, 3)) * 100).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, 60, 4000).astype(np.int32))
    got = k4.segment_sum(val.to(cuda_device), idx.to(cuda_device), 50).cpu()
    assert torch.equal(got, k4.segment_sum_plain(val, idx, 50))
    M, S = 500, 8
    st = dict(job_queue=rng.integers(0, S, M).astype(np.int32), job_valid=rng.random(M) < 0.9,
              group_job=rng.integers(0, M, M).astype(np.int32),
              job_priority=rng.integers(0, 3, M).astype(np.int32),
              job_creation_rank=rng.integers(0, 100, M).astype(np.int32),
              group_priority=rng.integers(0, 2, M).astype(np.int32),
              group_uid_rank=rng.integers(0, 100, M).astype(np.int32))
    args = [rng.random(M) < 0.8, rng.random(M) < 0.5,
            rng.integers(0, 3, M).astype(np.float32), rng.random(M) < 0.8]
    q, ok = t(np.arange(S, dtype=np.int64)), t(rng.random(S) < 0.9)
    cpu = k2.TurnPickPlan(types.SimpleNamespace(**{k: t(v) for k, v in st.items()}), PORT_TIERS)
    card = k2.TurnPickPlan(types.SimpleNamespace(**{k: t(v).to(cuda_device) for k, v in st.items()}),
                           PORT_TIERS)
    got = card.select(q.to(cuda_device), ok.to(cuda_device), *(t(a).to(cuda_device) for a in args))
    want = cpu.select(q, ok, *(t(a) for a in args))
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_evictive_kernels_match_plain_versions_on_card(cuda_device):
    rng = np.random.default_rng(10)
    seg, seg2, prio, uid, res = _layout_inputs(rng, 5000, 60, integral=False)
    lay = port_pre.SortLayout.build((t(seg2), t(seg)), t(prio), t(uid), t(res))
    dev_lay = port_pre.SortLayout(order=lay.order.to(cuda_device),
                                  seg_start=lay.seg_start.to(cuda_device),
                                  res_sorted=lay.res_sorted.to(cuda_device))
    mask = t(rng.random(5000) < 0.6)
    for got, want in zip(dev_lay.rank_and_cum(mask.to(cuda_device)), lay.rank_and_cum(mask)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_evictive_cycle_on_card_matches_cpu(cuda_device):
    arrays, _ = build_synthetic_arrays(2000, 200, num_queues=4, tasks_per_job=100, seed=1,
                                       running_fraction=0.5, fit_fraction=1.0)
    actions = ("reclaim", "allocate", "backfill", "preempt")
    gpu = port_cycle.schedule_cycle(from_numpy(arrays, cuda_device), actions=actions)
    cpu = port_cycle.schedule_cycle(from_numpy(arrays, "cpu"), actions=actions)
    for f in dataclasses.fields(cpu):
        assert torch.equal(getattr(gpu, f.name).cpu(), getattr(cpu, f.name)), f.name


@pytest.mark.cuda
@pytest.mark.parametrize("policy,pod_affinity", [("binpack", False), ("first_fit", True)])
def test_immediate_cycle_on_card_matches_cpu(cuda_device, policy, pod_affinity):
    """K9-K12 through the immediate path: binpack, and pod affinity under
    the evictive conf (with K6's split launch and _reclaim_fast)."""
    arrays, _ = build_synthetic_arrays(2000, 200, num_queues=8, tasks_per_job=100, seed=1,
                                       running_fraction=0.5, fit_fraction=1.0,
                                       pod_affinity=pod_affinity)
    actions = ("reclaim", "allocate", "backfill", "preempt")
    tiers = port_ord.with_node_order(policy)
    gpu = port_cycle.schedule_cycle(from_numpy(arrays, cuda_device), tiers=tiers, actions=actions)
    cpu = port_cycle.schedule_cycle(from_numpy(arrays, "cpu"), tiers=tiers, actions=actions)
    for f in dataclasses.fields(cpu):
        assert torch.equal(getattr(gpu, f.name).cpu(), getattr(cpu, f.name)), f.name


@pytest.mark.cuda
def test_cycle_on_card_matches_cpu(cuda_device):
    st = build_snapshot(_round_world(0).cluster).tensors
    arrays = pack_arrays(st)
    gpu = port_cycle.schedule_cycle(from_numpy(arrays, cuda_device))
    cpu = port_cycle.schedule_cycle(from_numpy(arrays, "cpu"))
    for f in dataclasses.fields(cpu):
        assert torch.equal(getattr(gpu, f.name).cpu(), getattr(cpu, f.name)), f.name
