"""K17's and K12's plans, held against the JAX package.

* ``QueueOrderPlan`` on the CPU (its plain route: the key build, then the
  stable sorts) equals ``jnp.lexsort`` over the key stack the reference
  builds (ops/allocate.py:1036-1040: ``queue_shares``, the tiered keys
  with BIG on inactive queues, the inactive flag) and its nq
  ``sum(q_active)``, on queue states with ties, -0.0, NaN, BIG, deserved
  of 0 and in (0, 1e-30), alloc > 0 over a zero total; under tiers with
  no, one and two proportion keys; launch after launch into the plan's
  own outputs.  The kernel's key build (``queue_keys_plain``'s share)
  equals ``fairness.queue_shares`` bit for bit on the same states and on
  subnormal ones.  XLA:CPU flushes subnormal floats to zero (a subnormal
  deserved is a zero total there, a subnormal share is 0); the port's
  share flushes them the same way (``common.safe_share``, ROADMAP C4), so
  the order is held against the reference on subnormal states too.
* ``PaShapePlan`` at every launch of an immediate allocate action (first
  fit and binpack) and of a preempt action on a pod-affinity pack at 5k x
  500: the rows it shapes in place equal the plain version of the rows
  before the launch and the reference's ``apply_seed`` /
  ``apply_domain_cap`` on them, and it reads the fit K11's plan just
  wrote.
* On a card (``cuda``-marked, skipped here): both plans, every route,
  against their plain versions.

Everything compared is an integer, a bool or a float compared bit for
bit: equal (tolerance: none).
"""
from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.ops import fairness as ref_fair
from kube_arbitrator_tpu.ops.common import BIG as REF_BIG
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import podaffinity as ref_pa
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import fairness as port_fair
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import pa_fit as k11
from kube_arbitrator_tpu_torch.ops.kernels import pa_shape as k12
from kube_arbitrator_tpu_torch.ops.kernels import queue_order as k17

BIG = np.float32(3.0e38)
R = 4


def _tiers(mod, n_prop):
    """(priority, gang) then drf and ``n_prop`` proportion plugins, in the
    reference's or the port's option types."""
    prop = tuple(mod.PluginOption.of("proportion") for _ in range(n_prop))
    return (mod.Tier(plugins=(mod.PluginOption.of("priority"), mod.PluginOption.of("gang"))),
            mod.Tier(plugins=(mod.PluginOption.of("drf"),) + prop))


def _queue_state(rng, Q, subnormal=False):
    """q_active, alloc, deserved, uid rank: shares that tie, sit on +-0.0,
    go NaN or past BIG; deserved 0 (alloc 0 or > 0) and in (0, 1e-30);
    with ``subnormal``, subnormal allocations and totals too."""
    pool_a = [0.0, -0.0, 1000.0, 2000.0, 500.0, np.nan, 3.0e38, 1e-20]
    pool_d = [0.0, -0.0, 1000.0, 2000.0, 4000.0, 1e-31, 1e-35, BIG, np.nan]
    if subnormal:
        pool_a, pool_d = pool_a + [1e-39, 5e-45], pool_d + [1e-40, 5e-45]
    pool_a, pool_d = np.array(pool_a, np.float32), np.array(pool_d, np.float32)
    alloc = pool_a[rng.integers(0, len(pool_a), (Q, R))]
    deserved = pool_d[rng.integers(0, len(pool_d), (Q, R))]
    uid = rng.permutation(Q).astype(np.int32)
    uid[rng.random(Q) < 0.2] = 0  # ties on the uid too
    return rng.random(Q) < 0.6, alloc, deserved, uid


def _ref_order(n_prop, active, alloc, deserved, uid):
    """The reference's B3 (ops/allocate.py:1036-1043) on numpy inputs."""
    q_active = jnp.asarray(active)
    q_share = ref_fair.queue_shares(jnp.asarray(alloc), jnp.asarray(deserved))
    keys = ref_ord.queue_order_keys(_tiers(ref_ord, n_prop), q_share, jnp.asarray(uid))
    keys = [jnp.where(q_active, k, REF_BIG) for k in keys]
    keys.insert(0, jnp.where(q_active, 0.0, 1.0))
    perm = jnp.lexsort(tuple(reversed(keys)))
    return np.asarray(perm), int(jnp.sum(q_active.astype(jnp.int32)))


@pytest.mark.parametrize("n_prop", [0, 1, 2])
@pytest.mark.parametrize("Q", [8, 64, 512])
def test_queue_order_plan_equals_reference_lexsort(Q, n_prop):
    rng = np.random.default_rng(Q + 7 * n_prop)
    plan = None
    for trial in range(4):
        active, alloc, deserved, uid = _queue_state(rng, Q)
        if plan is None:  # one plan over one session's deserved, as an action binds it
            d_t, u_t = torch.from_numpy(deserved), torch.from_numpy(uid)
            plan = k17.QueueOrderPlan(_tiers(port_ord, n_prop), d_t, u_t)
        else:
            deserved, uid = d_t.numpy(), u_t.numpy()
        want_perm, want_nq = _ref_order(n_prop, active, alloc, deserved, uid)
        perm, nq = plan(torch.from_numpy(active), torch.from_numpy(alloc))
        assert perm is plan.perm and nq is plan.nq, "the plan's own outputs"
        assert perm.dtype == torch.int64 and nq.dtype == torch.int32
        assert np.array_equal(perm.numpy(), want_perm), f"trial {trial}"
        assert int(nq) == want_nq
        # queue_perm through the plan and through a plan of its own
        for p in (plan, None):
            nq2, perm2 = port_alloc.queue_perm(_tiers(port_ord, n_prop), torch.from_numpy(active),
                                               torch.from_numpy(alloc), d_t, u_t, p)
            assert np.array_equal(perm2.numpy(), want_perm) and int(nq2) == want_nq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_keys_share_is_queue_shares(seed):
    """The key build's share is fairness.queue_shares' bit for bit, NaN
    for NaN, and the reference's (subnormals flushed in both), on normal
    and subnormal states."""
    rng = np.random.default_rng(seed)
    for subnormal in (True, False):
        active, alloc, deserved, uid = _queue_state(rng, 512, subnormal)
        keys = k17.queue_keys_plain(_tiers(port_ord, 1), torch.ones(512, dtype=torch.bool),
                                    torch.from_numpy(alloc), torch.from_numpy(deserved),
                                    torch.from_numpy(uid))
        want = port_fair.queue_shares(torch.from_numpy(alloc), torch.from_numpy(deserved))
        assert torch.equal(keys[1].view(torch.int32), want.view(torch.int32))
        ref = np.asarray(ref_fair.queue_shares(jnp.asarray(alloc), jnp.asarray(deserved)))
        got = keys[1].numpy()
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        ok = ~np.isnan(got)
        assert np.array_equal(got[ok], ref[ok]) and np.isnan(got).any() and (got == 0).any()


@pytest.mark.parametrize("Q", [8, 64, 512])
def test_queue_order_plan_equals_reference_on_subnormal_states(Q):
    """K17's plain form through ``QueueOrderPlan`` against the reference's
    ``queue_shares``-based order on states with subnormal allocations,
    totals and quotients (ROADMAP C4's rows among them)."""
    rng = np.random.default_rng(100 + Q)
    for n_prop in (1, 2):
        active, alloc, deserved, uid = _queue_state(rng, Q, subnormal=True)
        alloc[:3, 0], deserved[:3, 0] = [1e-39, 2e-38, 1.0], [1.0, 2000.0, 1e-39]
        active[:3] = True
        want_perm, want_nq = _ref_order(n_prop, active, alloc, deserved, uid)
        plan = k17.QueueOrderPlan(_tiers(port_ord, n_prop), torch.from_numpy(deserved),
                                  torch.from_numpy(uid))
        perm, nq = plan(torch.from_numpy(active), torch.from_numpy(alloc))
        assert np.array_equal(perm.numpy(), want_perm), n_prop
        assert int(nq) == want_nq


# ---------------------------------------------------------------- K12


def _pa_world(running_fraction):
    arrays, _ = build_synthetic_arrays(5000, 500, num_queues=8, tasks_per_job=50, seed=11,
                                       running_fraction=running_fraction, fit_fraction=1.25,
                                       pod_affinity=True)
    ref_st = ref_snapshot.SnapshotTensors(
        **{k: jnp.asarray(v) for k, v in arrays.items() if k != "rv_window"},
        rv_window=arrays["rv_window"])
    return from_numpy(arrays, "cpu"), ref_st


def _ref_shape(ref_st, fit, rows, nperm):
    """The reference's seed (in node order) then cap (in packing order)."""
    ref_fit = ref_pa.PodAffinityFit(*(jnp.asarray(x.numpy()) for x in fit))
    out = []
    for row in rows.numpy():
        node = row.copy()
        if nperm is not None:
            node[nperm.numpy()] = row
        ks = np.asarray(ref_pa.apply_seed(ref_st, ref_fit, jnp.asarray(node)))
        kp = ks if nperm is None else ks[nperm.numpy()]
        perm = None if nperm is None else jnp.asarray(nperm.numpy())
        out.append(np.asarray(ref_pa.apply_domain_cap(ref_st, ref_fit, jnp.asarray(kp), perm)))
    return np.stack(out)


def _track_shape_launches(monkeypatch, ref_st, fit_plans):
    """Check every PaShapePlan launch; returns the counts."""
    seen = dict(launches=0, changed=0, bound=0)
    call = k12.PaShapePlan.__call__
    made = k11.PaFitPlan.__init__

    def init(self, st):
        made(self, st)
        fit_plans.append(self)

    def checked(self, row=None):
        rows = self.k if row is None else row[None, :]
        before = rows.clone()
        # the fit the plan reads is the one K11's plan of this action just wrote
        assert any(self.fit is fp.fit for fp in fit_plans)
        got = call(self, row)
        assert got is (self.k if row is None else row), "shaped in place"
        want = k12.pa_shape_plain(self.st, self.fit, before, self.nperm)
        assert torch.equal(rows, want)
        assert np.array_equal(rows.numpy(), _ref_shape(ref_st, self.fit, before, self.nperm))
        seen["launches"] += 1
        seen["changed"] += int(not torch.equal(rows, before))
        seen["bound"] += int(row is None)
        return got

    monkeypatch.setattr(k11.PaFitPlan, "__init__", init)
    monkeypatch.setattr(k12.PaShapePlan, "__call__", checked)
    return seen


@pytest.mark.parametrize("policy", ["first_fit", "binpack"])
def test_pa_shape_plan_at_every_launch_of_an_immediate_allocate(monkeypatch, policy):
    st, ref_st = _pa_world(0.0)
    tiers = port_ord.with_node_order(policy)
    sess, state = port_cycle.open_session(st, tiers)
    fit_plans = []
    seen = _track_shape_launches(monkeypatch, ref_st, fit_plans)
    out = port_alloc.allocate_action(st, sess, state, tiers)
    monkeypatch.undo()
    assert len(fit_plans) == 1, "one K11 / K12 plan pair an action"
    assert seen["launches"] == seen["bound"] > 100 and seen["changed"] > 0
    assert out.rounds > 1 and int((out.task_node >= 0).sum()) > int((state.task_node >= 0).sum())


def test_pa_shape_plan_at_every_launch_of_a_preempt_action(monkeypatch):
    st, ref_st = _pa_world(0.5)
    tiers = port_ord.DEFAULT_TIERS
    sess, state = port_cycle.open_session(st, tiers)
    fit_plans = []
    seen = _track_shape_launches(monkeypatch, ref_st, fit_plans)
    out = port_pre.preempt_action(st, sess, state, tiers)
    monkeypatch.undo()
    assert seen["launches"] > 0 and seen["bound"] == 0, "the claim passes its capacity row"
    assert int((out.evicted_for != -1).sum()) > 0


def test_pa_shape_plan_refusals():
    st, _ = _pa_world(0.0)
    fit = k11.PaFitPlan(st).fit
    k = torch.zeros((2, st.num_nodes), dtype=torch.int32)
    with pytest.raises(ValueError):  # a packing order without bound rows
        k12.PaShapePlan(st, fit, None, torch.zeros(st.num_nodes, dtype=torch.int32))
    with pytest.raises(ValueError):
        k12.PaShapePlan(st, fit, k[:, :-1])
    with pytest.raises(ValueError):
        k12.PaShapePlan(st, fit, k, scratch="registers")
    with pytest.raises(ValueError):  # rows passed to a plan that binds its own
        k12.PaShapePlan(st, fit, k)(k[0])
    with pytest.raises(ValueError):
        k12.PaShapePlan(st, fit)()


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [8, 512, 4096])
def test_queue_order_plan_routes_on_card(cuda_device, Q):
    rng = np.random.default_rng(Q)
    for n_prop, subnormal in ((0, False), (1, False), (2, False), (1, True)):
        active, alloc, deserved, uid = _queue_state(rng, Q, subnormal)
        want_perm, want_nq = _ref_order(n_prop, active, alloc, deserved, uid)
        for variant in k17.VARIANTS:
            plan = k17.QueueOrderPlan(_tiers(port_ord, n_prop),
                                      torch.from_numpy(deserved).to(cuda_device),
                                      torch.from_numpy(uid).to(cuda_device), variant)
            for _ in range(2):
                perm, nq = plan(torch.from_numpy(active).to(cuda_device),
                                torch.from_numpy(alloc).to(cuda_device))
                assert np.array_equal(perm.cpu().numpy(), want_perm), (n_prop, variant)
                assert int(nq) == want_nq


@pytest.mark.cuda
@pytest.mark.parametrize("scratch", k12.SCRATCH)
def test_pa_shape_plan_routes_on_card(cuda_device, scratch):
    st, _ = _pa_world(0.0)
    rng = np.random.default_rng(3)
    N, K = st.num_nodes, st.node_dom.shape[0]
    dst = types.SimpleNamespace(node_dom=st.node_dom.to(cuda_device), num_nodes=N,
                                num_domains=st.num_domains)
    for trial in range(6):
        MA, MB = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        fit = k11.PodAffinityFit(
            torch.ones(N, dtype=torch.bool), torch.from_numpy(rng.random(MA) < 0.7),
            torch.from_numpy(rng.integers(0, K, MA).astype(np.int32)),
            torch.from_numpy(rng.random(MB) < 0.7),
            torch.from_numpy(rng.integers(0, K, MB).astype(np.int32)))
        k = rng.integers(0, 4, (2, N)) * (rng.random((2, N)) < 0.7)
        k = torch.from_numpy(k.astype(np.int32))
        nperm = None if trial % 2 else torch.from_numpy(rng.permutation(N).astype(np.int32))
        want = k12.pa_shape_plain(st, fit, k, nperm)
        dfit = k11.PodAffinityFit(*(x.to(cuda_device) for x in fit))
        dk = k.to(cuda_device)
        plan = k12.PaShapePlan(dst, dfit, dk, None if nperm is None else nperm.to(cuda_device),
                               scratch=scratch)
        assert plan() is dk and torch.equal(dk.cpu(), want), trial
        row = k[0].clone().to(cuda_device)
        k12.PaShapePlan(dst, dfit, scratch=scratch)(row)
        assert torch.equal(row.cpu(), k12.pa_shape_plain(st, fit, k[:1])[0]), trial
