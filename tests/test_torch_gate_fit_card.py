"""K14's ``UnionFitPlan`` and K15's ``WindowGatePlan`` on the card, each
held bit for bit against its plain version on the same inputs (the CPU
tests against the JAX package are in tests/test_torch_gate_fit_plans.py).
Every test here needs a CUDA card and skips without one.

* K14: the optimistic engine's first window of a 4k x 400 world with 64
  queues, through one plan: with ``ctl`` (START 0, a few rows before the
  trip, past it) and with the pop masked outside, i32 and i64 q, no
  claim, a claim only at the last row, and the batched engine's one-row
  form.
* K15: the same window's gate, a first claim at row 0, only at the last
  row, none, and a window a few rows before the trip: ``ctl``, ``sel``,
  ``q_entries``, ``job_consumed`` and ``progress``.
* Both opt-in engines, a whole action on the card against the same
  action on the CPU, every AllocState field and counter.
"""
from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import union_fit as k14
from kube_arbitrator_tpu_torch.ops.kernels import window_gate as k15

TIERS = port_ord.DEFAULT_TIERS
FIT_FORMS = ("ctl", "ctl, 3 rows before the trip", "ctl, past the trip", "masked, i32 q",
             "no claim", "last row", "one row")
GATE_FORMS = ("row 0", "last row", "none", "3 rows before the trip")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _arrays():
    arrays, _ = build_synthetic_arrays(4000, 400, num_queues=64, tasks_per_job=20, seed=2,
                                       running_fraction=0.5, fit_fraction=1.25)
    return arrays


def _window(dev):
    """The optimistic engine's first window on ``dev``: its pops, the
    products and the panel."""
    st = from_numpy(_arrays(), dev)
    sess, state = port_cycle.open_session(st, TIERS)
    state.progress = torch.zeros((), dtype=torch.bool, device=dev)
    use_gang, use_prop, preds_on = port_pre._reclaim_flags(TIERS)
    ctx = port_pre._canon_ctx(st, sess)
    carry = port_pre._canon_seed(st, state, ctx)
    RP = port_pre._reclaim_panel(st)
    nq, perm = port_pre._canon_round_order(st, sess, TIERS, state, carry)
    pops = port_pre._pick_pops(st, sess, TIERS)
    shared = port_pre._reclaim_shared(st, sess, state, TIERS, carry.job_consumed)
    q_panel = perm[:RP].clone()
    rows = tuple(x.clone() for x in port_pre.reclaim_select_turns(
        st, sess, state, TIERS, shared, q_panel, carry.q_entries, pops))
    products = port_pre._products_plan(st, sess, state, ctx, carry, use_gang, use_prop)
    products()
    return types.SimpleNamespace(st=st, state=state, ctx=ctx, carry=carry, RP=RP,
                                 trip=max(int(nq), 1), rows=rows, q_panel=q_panel,
                                 products=products, preds_on=preds_on)


def _fit_rows(w, form):
    """(rows, start or None for no ctl, plan rows) of one K14 form."""
    jp, gp, hgp, reqp, popp, burnp = w.rows
    q = w.q_panel
    if form == "ctl":
        return (q, gp, hgp, popp, reqp), 0, w.RP
    if form == "ctl, 3 rows before the trip":
        return (q, gp, hgp, popp, reqp), w.trip - 3, w.RP
    if form == "ctl, past the trip":
        return (q, gp, hgp, popp, reqp), w.trip, w.RP
    inw = popp & (torch.arange(w.RP, device=popp.device) < w.trip)
    if form == "masked, i32 q":
        return (q.to(torch.int32), gp, hgp, inw, reqp), None, w.RP
    if form == "no claim":
        return (q, gp, hgp, inw, torch.full_like(reqp, 3.0e38)), None, w.RP
    if form == "last row":
        p = torch.zeros_like(popp)
        p[-1] = True
        return (q.flip(0), gp.flip(0), hgp.flip(0), p, reqp.flip(0).contiguous()), None, w.RP
    return (q[:1], gp[:1], hgp[:1], popp[:1], reqp[0]), None, 1


def _plain_fit(w, rows, start, n):
    st, s = w.st, w.state
    _, pn, segcum = w.products.out
    q, g, hg, pop, req = rows
    if start is not None:
        pop = pop & (torch.arange(n, device=pop.device) + start < w.trip)
    cpu = [x.cpu() for x in (q, g, hg, pop, req.reshape(n, -1))]
    st_cpu = from_numpy(_arrays(), "cpu")
    return k14.union_fit_plain(st_cpu, w.ctx.skey.cpu(), segcum.cpu(), pn.cpu(), *cpu,
                               s.node_ports.cpu(), s.node_num_tasks.cpu(), w.preds_on)


@pytest.mark.cuda
@pytest.mark.parametrize("form", FIT_FORMS)
def test_fit_plan_on_card_matches_plain(cuda_device, form):
    w = _window(cuda_device)
    rows, start, n = _fit_rows(w, form)
    plan = port_pre._fit_plan(w.st, w.state, w.ctx, w.products, w.preds_on, n)
    ctl = None
    if start is not None:
        ctl, _ = k15.new_gate(1, cuda_device)
        ctl[k15.START], ctl[k15.TRIP] = start, w.trip
    n0 = k14.union_fit.launches
    got = plan(*rows, ctl=ctl)
    torch.cuda.synchronize()
    assert k14.union_fit.launches == n0 + 1 and got is plan.pick
    want = _plain_fit(w, rows, start, n)
    assert torch.equal(got.cpu(), want), form
    if form in ("ctl", "last row", "one row"):
        assert (want < w.st.num_nodes).any()


def _gate_pick(w, form, dev):
    jp, gp, hgp, reqp, popp, burnp = w.rows
    N = w.st.num_nodes
    start = w.trip - 3 if form == "3 rows before the trip" else 0
    if form in ("last row", "none"):
        pick = torch.full((w.RP,), N, dtype=torch.int32, device=dev)
        if form == "last row":
            pick[-1] = 1
        return pick, start
    ctl, _ = k15.new_gate(1, dev)
    ctl[k15.START], ctl[k15.TRIP] = start, w.trip
    plan = port_pre._fit_plan(w.st, w.state, w.ctx, w.products, w.preds_on, w.RP)
    return plan(w.q_panel, gp, hgp, popp, reqp, ctl=ctl).clone(), start


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("form", GATE_FORMS)
def test_gate_plan_on_card_matches_plain(cuda_device, form, q_dtype):
    w = _window(cuda_device)
    jp, gp, hgp, reqp, popp, burnp = w.rows
    pick, start = _gate_pick(w, form, cuda_device)
    q_panel = w.q_panel.to(q_dtype)
    R = reqp.shape[1]
    base = dict(q_entries=w.carry.q_entries, job_consumed=w.carry.job_consumed,
                progress=w.state.progress)
    g_t = {k: v.clone() for k, v in base.items()}
    plan = k15.WindowGatePlan(pick, w.st.num_nodes, jp, gp, hgp, popp, burnp, g_t["q_entries"],
                              g_t["job_consumed"], R)
    plan.ctl[k15.START], plan.ctl[k15.TRIP] = start, w.trip
    n0 = k15.window_gate.launches
    plan(q_panel, reqp, g_t["progress"])
    torch.cuda.synchronize()
    assert k15.window_gate.launches == n0 + 1
    c_t = {k: v.cpu().clone() for k, v in base.items()}
    c_ctl, c_sel = k15.new_gate(R, "cpu")
    c_ctl[k15.START], c_ctl[k15.TRIP] = start, w.trip
    k15.window_gate_plain(pick.cpu(), w.st.num_nodes, q_panel.cpu(), jp.cpu(), gp.cpu(),
                          hgp.cpu(), reqp.cpu(), popp.cpu(), burnp.cpu(), c_ctl,
                          c_t["q_entries"], c_t["job_consumed"], c_t["progress"], c_sel)
    assert torch.equal(plan.ctl.cpu(), c_ctl), (form, plan.ctl.tolist(), c_ctl.tolist())
    for a, b in zip(plan.sel, c_sel):
        assert torch.equal(a.cpu(), b), form
    for k in base:
        assert torch.equal(g_t[k].cpu(), c_t[k]), (form, k)


@pytest.mark.cuda
@pytest.mark.parametrize("turn_batch", [True, "optimistic"])
def test_engines_on_card_match_cpu(cuda_device, turn_batch):
    """A whole opt-in reclaim action on the card equals the same action
    on the CPU in every AllocState field and counter."""
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        st = from_numpy(_arrays(), dev)
        sess, state = port_cycle.open_session(st, TIERS)
        out[dev.type] = port_pre.reclaim_action(st, sess, state, TIERS, turn_batch=turn_batch)
    a, b = out["cuda"], out["cpu"]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.cpu(), y), f.name
        else:
            assert x == y, f.name
    assert (b.evict_phase == 3).sum() > 0
