"""K8's ``CanonCommitPlan`` and K20's ``OrderedScanPlan`` on the card,
each held bit for bit against its plain version on the same inputs (the
CPU tests against the JAX package are in
tests/test_torch_commit_scan_plans.py).  Every test here needs a CUDA
card and skips without one.

* K8: the canon walk's first round, turn by turn, committed through one
  plan in each canon engine's form, against the plain version on a copy
  of the same state, every carry and state field.
* K20: the plan, plain and masked, at the edges of the recursion's
  16-row blocks and of the 4,096-row tiles, C 1 / 3 / 4 / 9, each plan
  launched twice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import canon_commit as k8
from kube_arbitrator_tpu_torch.ops.kernels import ordered_scan as k20

TIERS = port_ord.DEFAULT_TIERS
STATE_FIELDS = ("job_alloc", "queue_alloc", "job_ready_cnt", "group_placed", "node_releasing",
                "node_ports", "node_num_tasks", "evict_claimant", "evict_phase", "evict_round")
# each canon engine's call form: q / j / g dtypes, claimed_out, active
FORMS = {
    "canon": dict(q=torch.int64, jg=torch.int32),
    "canon_i64": dict(q=torch.int64, jg=torch.int64),
    "batched": dict(q=torch.int64, jg=torch.int32, claimed_out=True),
    "optimistic": dict(q=torch.int32, jg=torch.int32, active=True),
}


def _scan_input(V, C, seed):
    rng = np.random.default_rng(seed)
    x = (rng.integers(1, 64_000, size=(V, C)) * rng.random((V, C))).astype(np.float32)
    x[rng.random((V, C)) < 0.05] = -0.0
    return x


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _port_world(dev, seed=1):
    arrays, _ = build_synthetic_arrays(4000, 400, num_queues=8, tasks_per_job=20, seed=seed,
                                       running_fraction=0.5, fit_fraction=1.25)
    pst = from_numpy(arrays, dev)
    sess, state = port_cycle.open_session(pst, TIERS)
    return pst, sess, state


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_commit_plan_on_card_matches_plain(cuda_device, form):
    """K8 through its plan, turn by turn over the first round of the canon
    walk, against the plain version on a copy of the same state."""
    spec = FORMS[form]
    pst, sess, state0 = _port_world(cuda_device)
    flags = port_pre._reclaim_flags(TIERS)
    state = port_alloc._copy(state0)
    state.progress = torch.zeros((), dtype=torch.bool, device=cuda_device)
    state.rounds = 0
    ctx = port_pre._canon_ctx(pst, sess)
    carry = port_pre._canon_seed(pst, state, ctx)
    plan = k8.CanonCommitPlan(pst, ctx, state, carry, *flags[:2])
    pick_plan = port_pre._pick_plan(pst, sess, state, ctx, carry, *flags)
    nq, perm = port_pre._canon_round_order(pst, sess, TIERS, state, carry)
    for qi in range(int(nq)):
        q = perm[qi:qi + 1]
        shared = port_pre._reclaim_shared(pst, sess, state, TIERS, carry.job_consumed)
        j, g, has_grp, req, pop, burn = port_pre._reclaim_pop(pst, sess, state, TIERS, shared,
                                                              q, carry.q_entries[q])
        pick = pick_plan(q, g, has_grp, pop, req).clone()
        s_ref, c_ref = port_alloc._copy(state), dataclasses.replace(
            carry, **{f.name: getattr(carry, f.name).clone() for f in dataclasses.fields(carry)})
        kw = {}
        if spec.get("claimed_out"):
            kw["claimed_out"] = torch.zeros(1, dtype=torch.bool, device=cuda_device)
        if spec.get("active"):
            kw["active"] = torch.ones(1, dtype=torch.bool, device=cuda_device)
        args = (pick, q.to(spec["q"]), j.to(spec["jg"]), g.to(spec["jg"]), has_grp, pop, burn,
                req)
        plan(*args, **kw)
        k8.canon_commit_plain(pst, ctx, s_ref, c_ref, *args, *flags[:2],
                              kw.get("active"), None)
        for f in dataclasses.fields(carry):
            assert torch.equal(getattr(carry, f.name), getattr(c_ref, f.name)), (qi, f.name)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(state, f), getattr(s_ref, f)), (qi, f)
        assert bool(state.progress) == bool(s_ref.progress)


@pytest.mark.cuda
@pytest.mark.parametrize("C", (1, 3, 4, 9))
@pytest.mark.parametrize("V", (1, 16, 17, 256, 257, 4095, 4096, 4097, 51_200, 65_536, 65_537,
                               200_000))
def test_scan_plan_on_card_matches_plain(cuda_device, V, C):
    x = torch.from_numpy(_scan_input(V, C, V * 7 + C))
    mask = torch.from_numpy(np.random.default_rng(V).random(V) < 0.7)
    want = k20.ordered_scan_plain(x)
    plan = k20.OrderedScanPlan(V, C, cuda_device)
    for _ in range(2):  # a second launch: the next launch number and ticket
        got = plan(x.to(cuda_device)).cpu()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    mplan = k20.OrderedScanPlan(V, C, cuda_device, rows=x.to(cuda_device))
    got = mplan(mask=mask.to(cuda_device)).cpu()
    want = k20.ordered_scan_plain(k20.masked_rows_plain(mask, x))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(mplan.masked.cpu(), k20.masked_rows_plain(mask, x))
