"""K5's ``SegScanPlan`` and K2's ``TurnPickPlan`` on the CPU, held
against the JAX package, and (on a GPU only) each kernel against its
plain version.

* K5: every victim layout of real victim views (the evictive worlds of
  tests/test_torch_preempt.py) and synthetic layouts (a padding tail, no
  masked row, one segment of all P, fractional values whose serial and
  tree sums differ) against the reference's ``SortLayout.rank_and_cum``
  with ``native_ops=True`` (the serial native scan, K5's order of adds),
  bit for bit; ``seg_cumsum`` (no order) against the native
  ``seg_cumsum_f32``; the plan's segment bases against the reference's
  ``base_idx`` (``_task_layout`` takes them in place of ``cummax``).
* K2: the plan's selection and reclaim pops against the reference's
  ``lex_argmin`` over the reference's key columns (ties, +-0.0, inf,
  keys at and past BIG, NaN, empty and all-true rows), and on a world
  against the reference's ``select_turns`` and ``_reclaim_pop``.
* The plans' ctypes structs mirror the C structs (K8's and K20's plans
  too); the plans own their outputs.

Inputs are made with numpy from a seed.  Every comparison is exact.
"""
from __future__ import annotations

import ctypes
import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.api import TaskStatus
from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.ops import allocate as ref_alloc
from kube_arbitrator_tpu.ops import common as ref_common
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu.ops.native import seg_cumsum_f32, segsum
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import common as port_common
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import build
from kube_arbitrator_tpu_torch.ops.kernels import canon_commit as k8
from kube_arbitrator_tpu_torch.ops.kernels import lex_argmin as k2
from kube_arbitrator_tpu_torch.ops.kernels import ordered_scan as k20
from kube_arbitrator_tpu_torch.ops.kernels import seg_scan as k5

LAYOUTS = ("by_job", "by_queue", "by_node_queue")
RUNNING = int(TaskStatus.RUNNING)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def native_scan():
    """The reference's native serial scan (built and registered once)."""
    assert segsum.available(), segsum._state["why"]


# ---------------------------------------------------------------- K5


def _world(tasks, nodes, seed, running=0.5, queues=8, fit=1.25):
    """(port pack on the CPU, reference pack) of one synthetic world."""
    arrays, _ = build_synthetic_arrays(tasks, nodes, num_queues=queues, tasks_per_job=100,
                                       seed=seed, running_fraction=running, fit_fraction=fit)
    ref_st = ref_snapshot.SnapshotTensors(
        **{k: jnp.asarray(v) for k, v in arrays.items() if k != "rv_window"},
        rv_window=arrays["rv_window"])
    return from_numpy(arrays, "cpu"), ref_st


def _ref_layout(order, seg_start, res_sorted):
    """The reference's SortLayout over a given order (its ``build`` sorts
    by the same keys; the sort is held elsewhere)."""
    order = jnp.asarray(order.numpy())
    n = order.shape[0]
    pos = jnp.arange(n)
    start = jnp.asarray(seg_start.numpy()).at[0].set(True)
    return ref_pre.SortLayout(
        order=order, inv=jnp.zeros(n, jnp.int32).at[order].set(pos.astype(jnp.int32)),
        base_idx=jax.lax.associative_scan(jnp.maximum, jnp.where(start, pos, 0)),
        seg_start=start, res_sorted=jnp.asarray(res_sorted.numpy()))


def _assert_native_equal(plan, ref_lay, mask, what):
    rank, cum = plan(t(mask))
    assert rank is plan.rank and cum is plan.cum, "the plan's own outputs"
    want_rank, want_cum = ref_lay.rank_and_cum(jnp.asarray(mask), native_ops=True)
    assert np.array_equal(rank.numpy(), np.asarray(want_rank)), f"{what}: rank"
    assert np.array_equal(cum.numpy(), np.asarray(want_cum)), f"{what}: cum"


@pytest.fixture(scope="module")
def victim_views():
    """Victim views of two evictive worlds at the preempt entry state:
    the whole running set in a panel past it (a padding tail), and at
    the full task width."""
    views = []
    for tasks, nodes, seed in ((2000, 200, 1), (5000, 500, 42)):
        pst, _ = _world(tasks, nodes, seed)
        _, state = port_cycle.open_session(pst, port_ord.DEFAULT_TIERS)
        running0 = (state.task_status == RUNNING) & pst.task_valid & (state.task_node >= 0)
        n = int(running0.sum())
        for P in (n + 1500, pst.num_tasks):
            views.append((port_pre._build_view(pst, state, running0, P), state))
    return views


@pytest.mark.parametrize("layout", LAYOUTS)
def test_scan_plan_matches_native_rank_and_cum_on_victim_views(victim_views, layout):
    rng = np.random.default_rng(21)
    for vi, (view, state) in enumerate(victim_views):
        lay = getattr(view.layouts, layout)
        ref_lay = _ref_layout(lay.order, lay.seg_start, lay.res_sorted)
        running = view.running(state.task_status).numpy()
        P = running.shape[0]
        for name, mask in (("running", running), ("running, 60%", running & (rng.random(P) < 0.6)),
                           ("none", np.zeros(P, bool)), ("every slot", np.ones(P, bool))):
            _assert_native_equal(lay.plan, ref_lay, mask, f"view {vi} {layout} {name}")
        # the segment bases _task_layout takes in place of cummax
        assert np.array_equal(lay.plan.base_pos.numpy(), np.asarray(ref_lay.base_idx))


def _synthetic(case, rng, P=4096, C=4):
    order = rng.permutation(P).astype(np.int32)
    start = rng.random(P) < 0.02
    vals = rng.integers(0, 5000, (P, C)).astype(np.float32)
    mask = rng.random(P) < 0.6
    if case == "padding tail":  # a last segment of 3,000 slots, none masked
        start[P - 3000:] = False
        start[P - 3000] = True
        mask[order[P - 3000:]] = False
    elif case == "no masked row":
        mask[:] = False
    elif case == "one segment":
        start[:] = False
    elif case == "fractional":  # long segments: serial and tree sums differ
        start = rng.random(P) < 0.002
        vals = (rng.standard_normal((P, C)) * 1e3).astype(np.float32)
    return order, start, vals, mask


@pytest.mark.parametrize("case", ["padding tail", "no masked row", "one segment", "fractional"])
def test_scan_plan_on_synthetic_layouts_matches_native(case):
    """``native_ops=True``: the reference's serial scan, whose order K5
    keeps; at fractional values the reference's jnp tree scan
    (``native_ops=False``) gives other bits."""
    order, start, vals, mask = _synthetic(case, np.random.default_rng(22))
    plan = k5.SegScanPlan(t(order), t(start), t(vals))
    ref_lay = _ref_layout(t(order), t(start), t(vals))
    _assert_native_equal(plan, ref_lay, mask, case)
    if case == "fractional":
        tree = np.asarray(ref_lay.rank_and_cum(jnp.asarray(mask))[1])
        assert not np.array_equal(plan(t(mask))[1].numpy(), tree), "the orders must differ"


@pytest.mark.parametrize("cols", [None, 3])
def test_seg_cumsum_matches_the_native_serial_scan(cols):
    """``seg_cumsum`` (no order, every row masked, a plan of its own)
    against the reference's native ``seg_cumsum_f32`` at fractional
    values, [V] and [V, C]."""
    rng = np.random.default_rng(23)
    V = 3000
    x = (rng.standard_normal((V,) if cols is None else (V, cols)) * 1e4).astype(np.float32)
    start = rng.random(V) < 0.01
    got = port_common.seg_cumsum(t(x), t(start))
    x2 = x[:, None] if cols is None else x
    want = np.asarray(seg_cumsum_f32(jnp.asarray(x2), jnp.asarray(start)))
    assert np.array_equal(got.numpy(), want[:, 0] if cols is None else want)


def test_task_layout_bases_are_the_segment_starts():
    """``_task_layout``'s bases (K5's segment table, no cummax) are each
    sorted position's segment start, as cummax gave them."""
    pst, _ = _world(2000, 200, 3)
    _, state = port_cycle.open_session(pst, port_ord.DEFAULT_TIERS)
    vj, node = pst.task_job, state.task_node.clamp(min=0)
    lay, inv, base = port_pre._task_layout((vj, node), pst.task_priority, pst.task_uid_rank,
                                           pst.task_resreq)
    pos = torch.arange(lay.order.shape[0])
    assert torch.equal(base, torch.cummax(torch.where(lay.seg_start, pos, 0), dim=0).values)
    assert torch.equal(lay.order.to(torch.int64)[inv], pos)
    assert port_pre._task_layout(node, pst.task_priority, pst.task_uid_rank, pst.task_resreq,
                                 with_base=False)[2] is None


# ---------------------------------------------------------------- K2


PICK_CASES = ("ties", "signed zeros", "infinities", "big", "nan", "empty", "all true")


def _pick_tables(case, rng, J=300, G=420, Q=6):
    """A pack view of J jobs / G groups / Q queues and a round's state
    whose keys carry ``case``."""
    if case == "all true":
        Q = 1
    job_queue = (np.arange(J) % Q).astype(np.int32)
    prio = rng.integers(0, 3, J).astype(np.int32)
    ready = rng.random(J) < 0.5
    share = (rng.integers(0, 4, J) * 0.1).astype(np.float32)
    rank = rng.integers(0, J // 3, J).astype(np.int32)  # creation ranks with ties
    valid = rng.random(J) < 0.95
    pending = rng.random(J) < 0.8
    if case == "ties":
        prio[:], ready[:], share[:] = 1, True, 0.5
    elif case == "signed zeros":
        prio[:], ready[:] = 0, True
        share[:] = np.where(rng.random(J) < 0.5, np.float32(-0.0), np.float32(0.0))
    elif case == "infinities":
        share = np.where(rng.random(J) < 0.4, np.inf, -np.inf).astype(np.float32)
        share[job_queue == 1] = np.inf
    elif case == "big":  # at and past BIG, which non-candidates read as
        share = np.where(rng.random(J) < 0.5, np.float32(3.0e38), np.float32(3.2e38))
        share[job_queue == 2] = np.float32(3.2e38)
    elif case == "nan":
        share[rng.random(J) < 0.05] = np.nan
        prio[job_queue == 3], ready[job_queue == 3] = 1, True
        nan_job = np.nonzero(job_queue == 3)[0][4]
        share[nan_job], valid[nan_job], pending[nan_job] = np.nan, True, True
    elif case == "empty":
        pending[job_queue == 2] = False
    elif case == "all true":
        valid[:], pending[:] = True, True
    group_job = np.concatenate([np.arange(J), rng.integers(0, J, G - J)]).astype(np.int32)
    group_prio = rng.integers(0, 2, G).astype(np.int32)
    group_uid = rng.integers(0, G // 2, G).astype(np.int32)
    grp_elig = rng.random(G) < 0.85
    if case == "all true":
        grp_elig[:] = True
    st = types.SimpleNamespace(
        job_queue=job_queue, job_valid=valid, group_job=group_job, job_priority=prio,
        job_creation_rank=rank, group_priority=group_prio, group_uid_rank=group_uid,
        queue_valid=np.ones(Q, bool))
    state = dict(job_has_pending=pending, job_ready=ready, job_share=share, grp_elig=grp_elig)
    return st, state, Q


def _port_st(st):
    return types.SimpleNamespace(**{k: t(v) for k, v in vars(st).items()})


def _ref_pick(tiers, st, s, q, ok):
    """The reference: its key columns and ``lex_argmin`` twice, over the
    masks as ``_select_turn`` builds them."""
    jkeys = ref_ord.job_order_keys(tiers, jnp.asarray(st.job_priority), jnp.asarray(s["job_ready"]),
                                   jnp.asarray(st.job_creation_rank), jnp.asarray(s["job_share"]))
    gkeys = ref_ord.group_order_keys(tiers, jnp.asarray(st.group_priority),
                                     jnp.asarray(st.group_uid_rank))
    jmask = ((st.job_queue[None, :] == q[:, None]) & (s["job_has_pending"] & st.job_valid)[None, :]
             & ok[:, None])
    j, has_job = ref_common.lex_argmin([k[None, :] for k in jkeys], jnp.asarray(jmask))
    gmask = (st.group_job[None, :] == np.asarray(j)[:, None]) & s["grp_elig"][None, :] \
        & np.asarray(has_job)[:, None]
    g, has_grp = ref_common.lex_argmin([k[None, :] for k in gkeys], jnp.asarray(gmask))
    return [np.asarray(x) for x in (j, has_job, g, has_grp)] + [jmask]


TIER_SETS = {
    "default": (ref_ord.DEFAULT_TIERS, port_ord.DEFAULT_TIERS),
    "priority and drf": tuple(
        (m.Tier(plugins=(m.PluginOption.of("priority"), m.PluginOption.of("drf"))),)
        for m in (ref_ord, port_ord)),
}


@pytest.mark.parametrize("tiers", list(TIER_SETS))
@pytest.mark.parametrize("case", PICK_CASES)
def test_turn_pick_select_matches_reference_lex_argmin(case, tiers):
    ref_tiers, port_tiers = TIER_SETS[tiers]
    rng = np.random.default_rng(31 + PICK_CASES.index(case))
    st, s, Q = _pick_tables(case, rng)
    q = np.concatenate([np.arange(Q), rng.integers(0, Q, 3)]).astype(np.int64)
    ok = rng.random(q.shape[0]) < 0.85
    ok[:Q] = True
    plan = k2.TurnPickPlan(_port_st(st), port_tiers)
    got = plan.select(t(q), t(ok), *(t(s[k]) for k in ("job_has_pending", "job_ready",
                                                         "job_share", "grp_elig")), jmask=True)
    want = _ref_pick(ref_tiers, st, s, q, ok)
    for name, a, b in zip(("j", "has_job", "g", "has_grp", "jmask"), got, want):
        assert np.array_equal(a.numpy(), b.astype(a.numpy().dtype)), f"{case}: {name}"
    if case == "nan" and tiers == "default":
        assert int(got[0][3]) == 0 and bool(got[1][3]), "a NaN key leaves index 0"
    if case == "big":
        assert int(got[0][2]) == 0, "keys past BIG leave index 0"
    if case == "empty":
        assert not bool(got[1][2])
    if case == "all true":
        assert bool(got[4].all())


@pytest.mark.parametrize("case", PICK_CASES)
def test_turn_pick_pop_matches_reference(case):
    """The reclaim rows: the OverusedFn filter (queue 1 overused, queue 0
    out of entries) in front of the same picks; pop and burn_now as
    ``_reclaim_pop`` derives them."""
    rng = np.random.default_rng(41 + PICK_CASES.index(case))
    st, s, Q = _pick_tables(case, rng)
    R = 4
    deserved = (rng.integers(1, 5, (Q, R)) * 1000).astype(np.float32)
    alloc = (rng.integers(0, 5, (Q, R)) * 1000).astype(np.float32)
    if Q > 1:
        alloc[1] = deserved[1] + 10.0
    q = np.arange(Q, dtype=np.int64)
    q_entry = rng.integers(1, 4, Q).astype(np.int32)
    q_entry[0] = 0
    plan = k2.TurnPickPlan(_port_st(st), port_ord.DEFAULT_TIERS, t(deserved))
    j, g, has_grp, pop, burn = plan.pop(t(q), t(q_entry), t(alloc), *(
        t(s[k]) for k in ("job_has_pending", "job_ready", "job_share", "grp_elig")))
    d, a = jnp.asarray(deserved[:, :3]), jnp.asarray(alloc[:, :3])
    q_over = np.asarray((d < a + ref_common.EPS).all(axis=-1))
    active = q_entry > 0
    want = _ref_pick(ref_ord.DEFAULT_TIERS, st, s, q, active & ~q_over)
    assert np.array_equal(j.numpy(), want[0]) and np.array_equal(g.numpy(), want[2]), case
    assert np.array_equal(has_grp.numpy(), want[3]), case
    assert np.array_equal(pop.numpy(), active & ~q_over & want[1]), case
    assert np.array_equal(burn.numpy(), active & (q_over | ~want[1])), case


@pytest.fixture(scope="module")
def evict_world():
    pst, ref_st = _world(2000, 200, 7)
    rsess, rstate = jax.jit(lambda s: ref_cycle.open_session(s, ref_ord.DEFAULT_TIERS))(ref_st)
    psess, pstate = port_cycle.open_session(pst, port_ord.DEFAULT_TIERS)
    # a NaN share, an infinite one and a negative zero among the jobs
    rows = np.array([3, 11, 20])
    alloc = np.asarray(rstate.job_alloc).copy()
    alloc[rows, 0] = np.array([np.nan, np.inf, -0.0], np.float32)
    rstate = dataclasses.replace(rstate, job_alloc=jnp.asarray(alloc))
    pstate.job_alloc = t(alloc)
    return pst, ref_st, psess, pstate, rsess, rstate


@pytest.mark.parametrize("mode", ["allocate", "backfill", "preempt"])
def test_select_turns_matches_reference_on_a_world(evict_world, mode):
    pst, ref_st, psess, pstate, rsess, rstate = evict_world
    tiers, ref_tiers = port_ord.DEFAULT_TIERS, ref_ord.DEFAULT_TIERS
    Q = pst.num_queues
    q = torch.arange(Q, dtype=torch.int64)
    ok = pst.queue_valid.clone()
    ok[1] = False
    be = mode == "backfill"
    shared = port_alloc._selection_shared(pst, psess, pstate, tiers, be)
    plan = k2.TurnPickPlan(pst, tiers)
    got = port_alloc.select_turns(pst, psess, pstate, tiers, 4096, mode, shared, q, ok, plan)

    @jax.jit
    def ref(st, sess, state, qv, okv):
        sh = ref_alloc._selection_shared(st, sess, state, ref_tiers, be)
        return ref_alloc.select_turns(st, sess, state, ref_tiers, 4096, mode, sh, qv, okv)

    want = ref(ref_st, rsess, rstate, jnp.asarray(q.numpy()), jnp.asarray(ok.numpy()))
    for name, a, b in zip(("j", "g", "has_grp", "req", "budget"), got, want):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype)), f"{mode}: {name}"


def test_reclaim_pops_match_reference_on_a_world(evict_world):
    pst, ref_st, psess, pstate, rsess, rstate = evict_world
    tiers, ref_tiers = port_ord.DEFAULT_TIERS, ref_ord.DEFAULT_TIERS
    Q, J = pst.num_queues, pst.num_jobs
    consumed = np.zeros(J, bool)
    consumed[::5] = True
    q_entries = np.full(Q, 2, np.int32)
    q_entries[2] = 0
    shared = port_pre._reclaim_shared(pst, psess, pstate, tiers, t(consumed))
    plan = port_pre._pick_pops(pst, psess, tiers)
    q = torch.arange(Q, dtype=torch.int64)
    got = port_pre.reclaim_select_turns(pst, psess, pstate, tiers, shared, q, t(q_entries), plan)

    @jax.jit
    def ref(st, sess, state, cons, qe):
        sh = ref_pre._reclaim_shared(st, sess, state, ref_tiers, cons)
        return ref_pre.reclaim_select_turns(st, sess, state, ref_tiers, sh, jnp.arange(Q), qe)

    want = ref(ref_st, rsess, rstate, jnp.asarray(consumed), jnp.asarray(q_entries))
    for name, a, b in zip(("j", "g", "has_grp", "req", "pop", "burn_now"), got, want):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype)), name


def test_turn_pick_plan_owns_its_outputs():
    """One set of outputs per (rows, form): a second selection of as many
    rows overwrites the first; another row count keeps its own."""
    rng = np.random.default_rng(51)
    st, s, Q = _pick_tables("ties", rng)
    plan = k2.TurnPickPlan(_port_st(st), port_ord.DEFAULT_TIERS)
    args = [t(s[k]) for k in ("job_has_pending", "job_ready", "job_share", "grp_elig")]
    ok = torch.ones(Q, dtype=torch.bool)
    a = plan.select(torch.arange(Q), ok, *args)
    b = plan.select(torch.arange(Q).flip(0), ok, *args)
    assert a[0] is b[0] and a[2] is b[2] and torch.equal(a[0], b[0])
    c = plan.select(torch.arange(1), ok[:1], *args)
    assert c[0] is not a[0] and c[0].shape == (1,)


# ---------------------------------------------------------------- structs


def _c_fields(source: str, struct: str):
    """[(name, is_pointer, array length or 0)] of ``struct <struct>`` in
    csrc/<source>.cu."""
    text = (build.CSRC / f"{source}.cu").read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"([\w\s]+?)(\**)\s*(\w+(?:\[\w+\])?(?:\s*,\s*\w+)*)$", decl)
        for n in m.group(3).split(","):
            arr = re.match(r"(\w+)\[(\w+)\]", n.strip())
            fields.append((arr.group(1), False, consts[arr.group(2)]) if arr
                          else (n.strip(), bool(m.group(2)), 0))
    return fields


@pytest.mark.parametrize("mod,source,struct,cls", [
    (k2, "lex_argmin", "Static", "_Static"), (k2, "lex_argmin", "Call", "_Call"),
    (k5, "seg_scan", "Static", "_Static"), (k8, "canon_commit", "Static", "_Static"),
    (k8, "canon_commit", "Turn", "_Turn"), (k20, "ordered_scan", "Static", "_Static"),
    (k20, "ordered_scan", "Call", "_Call")])
def test_plan_structs_mirror_the_c_structs(mod, source, struct, cls):
    got = [(name, typ is ctypes.c_void_p, getattr(typ, "_length_", 0))
           for name, typ in getattr(mod, cls)._fields_]
    assert got == _c_fields(source, struct)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_scan_plan_on_card_equals_plain(cuda_device, victim_views):
    rng = np.random.default_rng(61)
    for view, state in victim_views:
        running = view.running(state.task_status)
        for name in LAYOUTS:
            lay = getattr(view.layouts, name)
            plan = k5.SegScanPlan(*(x.to(cuda_device) for x in (lay.order, lay.seg_start,
                                                                  lay.res_sorted)))
            assert torch.equal(plan.base_pos.cpu(), lay.plan.base_pos)
            for mask in (running, running & t(rng.random(running.shape[0]) < 0.5),
                         torch.zeros_like(running)):
                for a, b in zip(plan(mask.to(cuda_device)), lay.plan(mask)):
                    assert torch.equal(a.cpu(), b), name
    for case in ("padding tail", "no masked row", "one segment", "fractional"):
        order, start, vals, mask = _synthetic(case, rng)
        got = k5.SegScanPlan(*(t(x).to(cuda_device) for x in (order, start, vals)))(
            t(mask).to(cuda_device))
        want = k5.seg_scan_plain(t(mask), t(order), t(start), t(vals))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), case
    x = t(rng.standard_normal((5000, 3)).astype(np.float32))
    start = t(rng.random(5000) < 0.01)
    assert torch.equal(port_common.seg_cumsum(x.to(cuda_device), start.to(cuda_device)).cpu(),
                       port_common.seg_cumsum(x, start))


@pytest.mark.cuda
@pytest.mark.parametrize("case", PICK_CASES)
def test_turn_pick_plan_on_card_equals_plain(cuda_device, case):
    rng = np.random.default_rng(71 + PICK_CASES.index(case))
    st, s, Q = _pick_tables(case, rng)
    deserved = t((rng.integers(1, 5, (Q, 4)) * 1000).astype(np.float32))
    alloc = t((rng.integers(0, 5, (Q, 4)) * 1000).astype(np.float32))
    q = t(np.arange(Q, dtype=np.int64))
    ok = t(rng.random(Q) < 0.8)
    q_entry = t(rng.integers(0, 3, Q).astype(np.int32))
    args = [t(s[k]) for k in ("job_has_pending", "job_ready", "job_share", "grp_elig")]
    dev_st = types.SimpleNamespace(**{k: v.to(cuda_device) for k, v in vars(_port_st(st)).items()})
    card = k2.TurnPickPlan(dev_st, port_ord.DEFAULT_TIERS, deserved.to(cuda_device))
    cpu = k2.TurnPickPlan(_port_st(st), port_ord.DEFAULT_TIERS, deserved)
    d = [a.to(cuda_device) for a in args]
    for got, want in ((card.select(q.to(cuda_device), ok.to(cuda_device), *d, jmask=True),
                       cpu.select(q, ok, *args, jmask=True)),
                      (card.pop(q.to(cuda_device), q_entry.to(cuda_device),
                                alloc.to(cuda_device), *d),
                       cpu.pop(q, q_entry, alloc, *args))):
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), case
