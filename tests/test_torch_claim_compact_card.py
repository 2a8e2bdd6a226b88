"""K6's ``ClaimNodesPlan`` and K16's one-launch compaction on the card,
each held bit for bit against its plain version on the same inputs (the
CPU tests against the JAX package are in
tests/test_torch_claim_compact_plans.py).  Every test here needs a CUDA
card and skips without one.

* K6: the first preempt turn of a 5k x 500 evictive world through one
  plan — i32 and i64 g, preempt and preempt_intra, no victim, the
  statement gate dropping the claim, budget 0 — and its folded
  aggregates against ``claim_aggregates`` on the card (K4's slot-order
  sums, the scatter max / min); the pod-affinity world's turns through
  the two launches around K12.
* A whole preempt action on the card against the same action on the CPU
  (batched and sequential; the pod-affinity world's sequential loop),
  every AllocState field and counter.
* K16: one row past its cap, a panel, [K, L] rows, FeasCells at K = 3, an
  empty mask, a cap of one, L not a multiple of the chunk, and the
  commit's two lists from one launch; one stream for the count words,
  and a bounded cache of plans.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kube_arbitrator_tpu_torch.api.types import TaskStatus
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import claim_nodes as k6
from kube_arbitrator_tpu_torch.ops.kernels import stable_compact as k16

TIERS = port_ord.DEFAULT_TIERS
RUNNING = int(TaskStatus.RUNNING)
TURN = ("victims", "node_rank", "node_cum", "node_ports", "node_num_tasks", "g", "req", "budget",
        "has_grp", "was_ready", "need")
FORMS = ("i64 g", "i32 g", "preempt_intra", "no victim", "keep false", "budget 0")
FIELDS = ("task_status", "task_node", "evicted_for", "job_ready_cnt", "group_placed", "job_alloc",
          "queue_alloc", "node_num_tasks", "node_releasing", "node_ports", "evict_claimant",
          "evict_phase", "evict_round", "group_unfit")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _arrays(pod_affinity=False):
    if pod_affinity:
        return build_synthetic_arrays(5000, 500, num_queues=8, tasks_per_job=50, seed=11,
                                      running_fraction=0.5, fit_fraction=1.25,
                                      pod_affinity=True)[0]
    return build_synthetic_arrays(5000, 500, num_queues=8, tasks_per_job=100, seed=43,
                                  running_fraction=0.5, fit_fraction=1.0)[0]


def _entry(dev, pod_affinity=False):
    """(pack, session, state) at the preempt entry of one cycle on ``dev``."""
    st = from_numpy(_arrays(pod_affinity), dev)
    sess, state = port_cycle.open_session(st, TIERS)
    state = port_pre.reclaim_action(st, sess, state, TIERS)
    state = port_alloc.allocate_action(st, sess, state, TIERS)
    return st, sess, port_alloc.backfill_action(st, sess, state, TIERS)


def _turns(st, sess, state, view):
    """Each queue's preempt turn in the round's order (the victims of its
    claimant), as ``_apply_claim`` takes them."""
    q_active = port_pre._round_gate(st, sess, state, "preempt", view)
    _, perm = port_pre._queue_perm(st, sess, state, TIERS, q_active)
    shared = port_alloc._selection_shared(st, sess, state, TIERS, None)
    P = view.idx.shape[0]
    for qi in range(st.num_queues):
        q = perm[qi:qi + 1]
        j, g, has_grp, req, budget = port_alloc.select_turns(
            st, sess, state, TIERS, 4096, "preempt", shared, q, st.queue_valid[q] & q_active[q])
        was_ready = shared[3][j]
        need = (sess.min_avail[j] - state.job_ready_cnt[j]).clamp(min=0)
        budget = port_pre._phase_budget("preempt", budget, was_ready, need, has_grp,
                                        shared[0][g], 4096)
        scope = view.running(state.task_status) & (view.job != j) & (view.queue == q)
        victims = port_pre._victim_verdict(st, state, sess, TIERS, scope, j.expand(P),
                                           req.expand(P, req.shape[1]), view) & has_grp
        nr, nc = (x.clone() for x in view.layouts.by_node_queue.rank_and_cum(victims))
        yield dict(victims=victims, node_rank=nr, node_cum=nc, node_ports=state.node_ports,
                   node_num_tasks=state.node_num_tasks, g=g.to(torch.int64),
                   req=req[0].contiguous(), budget=budget, has_grp=has_grp, was_ready=was_ready,
                   need=need)


def _view(st, state):
    running0 = (state.task_status == RUNNING) & st.task_valid & (state.task_node >= 0)
    return port_pre._build_view(st, state, running0, st.num_tasks)


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        vals = [_cpu(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return dataclasses.replace(x, **{f.name: _cpu(getattr(x, f.name))
                                     for f in dataclasses.fields(x)})


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_claim_plan_on_card_matches_plain(cuda_device, form):
    st, sess, state = _entry(cuda_device)
    view = _view(st, state)
    turn = next(t for t in _turns(st, sess, state, view) if int(t["victims"].sum()))
    mode = "preempt_intra" if form == "preempt_intra" else "preempt"
    if form == "i32 g":
        turn["g"] = turn["g"].to(torch.int32)
    elif form == "no victim":
        turn["victims"] = torch.zeros_like(turn["victims"])
    elif form == "keep false":
        turn.update(was_ready=torch.zeros_like(turn["was_ready"]),
                    budget=torch.full_like(turn["budget"], 4096),
                    need=torch.full_like(turn["need"], 4096))
    elif form == "budget 0":
        turn["budget"] = torch.zeros_like(turn["budget"])
    plan = port_pre._claim_plan(st, TIERS, view, 4096, mode)
    n0 = k6.ClaimNodesPlan.launches
    got = plan(**turn)
    assert k6.ClaimNodesPlan.launches == n0 + 1
    st_cpu, vc = from_numpy(_arrays(), "cpu"), _cpu(view)
    want = k6.claim_nodes_plain(st_cpu, vc.node, vc.node_order, vc.resreq,
                                *(_cpu(turn[k]) for k in TURN), 4096, mode == "preempt", True)
    for name, a, b in zip(("p", "cum", "placed", "evict", "freed"), got, want):
        assert torch.equal(a.cpu(), b), (form, name)
    if form in ("i64 g", "i32 g", "preempt_intra"):
        assert int(got[2][0]) > 0 and int(got[3].sum()) > 0


@pytest.mark.cuda
def test_folded_aggregates_on_card_match_claim_aggregates(cuda_device):
    st, sess, state = _entry(cuda_device)
    view = _view(st, state)
    plan = k6.ClaimNodesPlan(st, view, 4096, True, True, aggregates=True)
    seen = 0
    for turn in _turns(st, sess, state, view):
        plan(**turn)
        want = k6.claim_aggregates(view.node, view.node_order, view.resreq, turn["victims"],
                                   st.num_nodes)
        for a, b in zip(plan.aggs, want):
            assert torch.equal(a, b)
        seen += int(turn["victims"].sum() > 0)
    assert seen > 1


@pytest.mark.cuda
def test_claim_plan_with_pod_affinity_on_card_matches_plain(cuda_device):
    from kube_arbitrator_tpu_torch.ops.kernels import pa_shape as k12

    st, sess, state = _entry(cuda_device, pod_affinity=True)
    view = _view(st, state)
    plan = port_pre._claim_plan(st, TIERS, view, 4096, "preempt")
    assert plan.pa is not None
    st_cpu, vc = from_numpy(_arrays(True), "cpu"), _cpu(view)
    placed = 0
    for turn in _turns(st, sess, state, view):
        plan.pa[0](turn["g"], state.task_status, state.task_node)
        fit = _cpu(plan.pa[0].fit)
        want = k6.claim_nodes_plain(st_cpu, vc.node, vc.node_order, vc.resreq,
                                    *(_cpu(turn[k]) for k in TURN), 4096, True, True,
                                    (fit.ok, k12.PaShapePlan(st_cpu, fit)))
        n0 = k6.ClaimNodesPlan.launches
        got = plan(**turn)
        assert k6.ClaimNodesPlan.launches == n0 + 2
        for name, a, b in zip(("p", "cum", "placed", "evict", "freed"), got, want):
            assert torch.equal(a.cpu(), b), name
        placed += int(got[2][1])
    assert placed > 0


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["batched", "sequential", "pod_affinity"])
def test_preempt_action_on_card_matches_cpu(cuda_device, engine):
    pa = engine == "pod_affinity"
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        st, sess, state = _entry(dev, pa)
        outs.append(port_pre.preempt_action(st, sess, state, TIERS,
                                            turn_batch=engine == "batched"))
    card, cpu = outs
    for f in FIELDS:
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), (engine, f)
    assert (card.rounds, card.rounds_gated) == (cpu.rounds, cpu.rounds_gated)
    assert int((cpu.evict_phase == 1).sum()) > 0


@pytest.mark.cuda
def test_compact_forms_on_card_match_plain(cuda_device):
    rng = np.random.default_rng(16)
    T = 102_400
    dev = cuda_device
    mask = torch.from_numpy(rng.random(T) < 0.6).to(dev)
    qual = torch.from_numpy(rng.random(T) < 0.3).to(dev)
    st, _, state = _entry(dev)
    cells = port_alloc._prune_cells(st, state, TIERS, False)
    cells3 = k16.FeasCells(cells.class_fit[torch.arange(3, device=dev) % cells.class_fit.shape[0]],
                           cells.node_klass, cells.node_valid, cells.node_unsched, True,
                           cells.minreq[:1] * torch.tensor([[0.5], [1.0], [4.0]], device=dev),
                           cells.basis)
    N = st.num_nodes
    cases = [(mask[None, :], 51_200, -1), (qual[None, :], 51_200, T), (cells, N // 4, N),
             (cells3, N // 4, N), (torch.stack([mask, qual, ~mask]), 40_000, -1),
             (torch.zeros_like(mask)[None, :], 4096, -1), (mask[None, :], 1, -1),
             (qual[None, :T - 777].contiguous(), 5000, -7)]
    for m, cap, pad in cases:
        K = m.shape[0]
        n0 = k16.stable_compact.launches
        got = k16.stable_compact(m, cap, pad)
        assert k16.stable_compact.launches == n0 + 1
        m_cpu = m.mask().cpu() if isinstance(m, k16.FeasCells) else m.cpu()
        want = k16.stable_compact_plain(m_cpu, cap, pad)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]), (K, cap)
    emask = torch.from_numpy(rng.random(T) < 0.02).to(dev)
    n0 = k16.stable_compact.launches
    (bi, bc), (ei, ec) = k16.stable_compact_pair(mask, 51_200, -1, emask, 12_800, -1)
    assert k16.stable_compact.launches == n0 + 1
    for (i, c), m, cap in (((bi, bc), mask, 51_200), ((ei, ec), emask, 12_800)):
        wi, wc = k16.stable_compact_plain(m.cpu()[None, :], cap, -1)
        assert torch.equal(i.cpu(), wi[0]) and int(c) == int(wc[0])


@pytest.mark.cuda
def test_compact_plans_keep_one_stream_and_a_bounded_cache(cuda_device):
    """K16's plans share their device's count words: a launch from another
    stream raises (and launches nothing), and past ``MAX_PLANS`` row
    shapes the oldest plan is dropped, each later launch still equal to
    the plain version."""
    rng = np.random.default_rng(7)
    mask = torch.from_numpy(rng.random(5000) < 0.5).to(cuda_device)
    k16.stable_compact(mask[None, :], 100, -1)  # the device's words and their stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        n0 = k16.stable_compact.launches
        with pytest.raises(RuntimeError, match="stream"):
            k16.stable_compact(mask[None, :], 100, -1)
        assert k16.stable_compact.launches == n0
    torch.cuda.synchronize()
    for L in range(4000, 4000 + k16.MAX_PLANS + 3):
        got = k16.stable_compact(mask[None, :L], 300, -1)
        want = k16.stable_compact_plain(mask[None, :L].cpu(), 300, -1)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]), L
    assert len(k16._PLANS) <= k16.MAX_PLANS
