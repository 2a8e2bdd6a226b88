"""K4's three forms and K13's plan, held against the JAX package and the
plain versions.

* K4's count route (an unordered ``segment_sum``: one launch that counts
  the segments, writes the slot order and sums over it): the order as
  the kernel builds it (``count_order_plain``: tile counts, their
  prefixes, per-warp ranks) equals K19's ``segment_order`` on the
  in-range slots at tile and warp edges, T = 0 and S up to the route's
  limit; the sums over it equal the reference's scatter
  (``.at[idx].add``) on f32 and i32, with out-of-range drops, ``out=``
  accumulation and empty segments.
* ``ordered_sum`` (one segment, no order tensor) equals the sequential
  sum row by row.
* ``segment_sum`` over a held order (one ``segment_order``, many sums,
  as ``open_session`` and preempt's victim panel call it) equals the
  reference's scatter call after call with changing values, into fresh
  outputs and accumulating into ``out``.
* ``RoundProductsPlan``, bound once per engine call, equals
  ``round_products_plain`` of the engine's live state at every launch of
  a batched and an optimistic engine run (64 queues), a clear ``dirty``
  flag leaving its outputs as they were; the engines decide like the
  canon walk.
* On a card (``cuda``-marked, skipped here): the same on the kernels.

f32 sums are compared bit for bit (tolerance: none): the slot order is
the contract, and the reverse order is shown to give other bits.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import round_products as k13
from kube_arbitrator_tpu_torch.ops.kernels import segment_sum as k4
from kube_arbitrator_tpu_torch.ops.kernels.stable_sort import segment_order_plain

TIERS = port_ord.DEFAULT_TIERS


def t(a):
    return torch.from_numpy(np.array(a))


def _ref_scatter(val, idx, S, base=None):
    """The reference's slot-order scatter: ``base.at[idx].add(val)``
    with out-of-range indices dropped."""
    if base is None:
        base = jnp.zeros((S,) + val.shape[1:], val.dtype)
    return np.asarray(jnp.asarray(base).at[jnp.where((idx >= 0) & (idx < S), idx, S)]
                      .add(val, mode="drop"))


def _count_sum(val, idx, S, out=None):
    """The count route's sums: the plain sums over the order it builds."""
    return k4.segment_sum_plain(val, idx, S, out, order=k4.count_order_plain(idx, S))


# ---------------------------------------------------------------- K4's count route


@pytest.mark.parametrize("n,S", [
    (0, 5), (1, 1), (1023, 3), (1024, 1), (1025, 40), (2 * 1024 + 129, 7),
    (8193, 1024), (5000, k4.COUNT_MAX_SEGMENTS),
])
def test_count_order_equals_segment_order(n, S):
    rng = np.random.default_rng(n + S)
    idx = t(rng.integers(-3, S + 3, n).astype(np.int32))
    perm, seg_start = k4.count_order_plain(idx, S)
    want_perm, want_start = segment_order_plain(idx, S)
    assert torch.equal(seg_start, want_start)
    assert torch.equal(perm, want_perm[: int(want_start[-1])])


@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("cols", [0, 3])
def test_count_route_sums_equal_reference_scatter(dtype, cols):
    """Many duplicates, segments with no slot (S past the largest index)
    and out-of-range slots on both sides."""
    rng = np.random.default_rng(11 + cols)
    T, S = 4100, 50
    shape = (T,) if cols == 0 else (T, cols)
    if dtype == "f32":
        val = (rng.standard_normal(shape) * 1e3).astype(np.float32) + np.float32(0.1)
    else:
        val = rng.integers(-100, 100, shape).astype(np.int32)
    idx = rng.integers(-2, 40, T).astype(np.int32)  # segments 40-49 empty
    got = _count_sum(t(val), t(idx), S)
    assert np.array_equal(got.numpy(), _ref_scatter(val, idx, S))
    assert torch.equal(got, k4.segment_sum(t(val), t(idx), S))
    if dtype == "f32":  # the reverse order gives other bits: the order is pinned
        keep = (idx[::-1] >= 0) & (idx[::-1] < S)
        rev = np.zeros((S,) + shape[1:], np.float32)
        np.add.at(rev, idx[::-1][keep], val[::-1][keep])
        assert not np.array_equal(rev, got.numpy())


def test_count_route_accumulates_into_out_and_takes_no_slots():
    rng = np.random.default_rng(12)
    val = (rng.standard_normal((3000, 4)) * 1e3).astype(np.float32)
    idx = rng.integers(-1, 12, 3000).astype(np.int32)
    base = (rng.standard_normal((11, 4)) * 1e6).astype(np.float32)
    out = t(base)
    assert _count_sum(t(val), t(idx), 11, out=out) is out
    assert np.array_equal(out.numpy(), _ref_scatter(val, idx, 11, base))
    # T = 0: zeros, or out untouched
    empty = torch.zeros((0, 4))
    none = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(_count_sum(empty, none, 11), torch.zeros((11, 4)))
    kept = t(base)
    assert torch.equal(_count_sum(empty, none, 11, out=kept), t(base))
    # every slot dropped
    assert torch.equal(_count_sum(t(val), t(np.full(3000, 11, np.int32)), 11),
                       torch.zeros((11, 4)))


# ---------------------------------------------------------------- ordered_sum


@pytest.mark.parametrize("n", [1, 500, 10_240])
@pytest.mark.parametrize("cols", [0, 5])
def test_ordered_sum_equals_sequential_sum(n, cols):
    rng = np.random.default_rng(n + cols)
    shape = (n,) if cols == 0 else (n, cols)
    val = (rng.standard_normal(shape) * 1e3).astype(np.float32)
    seq = np.zeros(shape[1:], np.float32)
    for row in val:  # row by row, in f32
        seq = (seq + row).astype(np.float32)
    got = k4.ordered_sum(t(val))
    assert got.shape == shape[1:]
    assert np.array_equal(got.numpy(), seq)
    ival = rng.integers(-50, 50, shape).astype(np.int32)
    assert np.array_equal(k4.ordered_sum(t(ival)).numpy(), ival.sum(axis=0))


# ---------------------------------------------------------------- a held order


def test_held_order_sums_equal_reference_call_after_call():
    rng = np.random.default_rng(13)
    T, S = 2500, 30
    idx = rng.integers(-1, S + 2, T).astype(np.int32)
    order = k4.segment_order(t(idx), S)
    acc = np.zeros((S, 2), np.float32)
    out = torch.zeros((S, 2))
    for step in range(4):
        val = (rng.standard_normal((T, 2)) * 10 ** step).astype(np.float32)
        got = k4.segment_sum(t(val), t(idx), S, order=order)
        assert np.array_equal(got.numpy(), _ref_scatter(val, idx, S))
        acc = _ref_scatter(val, idx, S, acc)
        assert k4.segment_sum(t(val), t(idx), S, out=out, order=order) is out
        assert np.array_equal(out.numpy(), acc)
        ival = rng.integers(-9, 9, T).astype(np.int32)
        got = k4.segment_sum(t(ival), t(idx), S, order=order)
        assert np.array_equal(got.numpy(), _ref_scatter(ival, idx, S))


def test_held_order_from_the_plain_sort():
    rng = np.random.default_rng(14)
    idx = t(rng.integers(0, 9, 700).astype(np.int32))
    val = t((rng.standard_normal((700, 3)) * 1e2).astype(np.float32))
    got = k4.segment_sum(val, idx, 9, order=segment_order_plain(idx, 9))
    assert torch.equal(got, k4.segment_sum_plain(val, idx, 9))


# ---------------------------------------------------------------- K13's plan


def _q64_world(device="cpu"):
    arrays, _ = build_synthetic_arrays(5000, 500, num_queues=64, tasks_per_job=20, seed=3,
                                       running_fraction=0.5, fit_fraction=1.25)
    return from_numpy(arrays, device)


@pytest.mark.parametrize("turn_batch", [True, "optimistic"])
def test_round_products_plan_tracks_the_engine_state(monkeypatch, turn_batch):
    """Every launch of the plan an engine binds once equals the plain
    version of the engine's live carry and state (a tensor the engine
    reassigned would leave the plan reading a stale one); a clear dirty
    flag leaves the products as they were."""
    pst = _q64_world()
    sess, state = port_cycle.open_session(pst, TIERS)
    seen = dict(plans=0, launches=0, clear=0)
    made = port_pre._products_plan

    def tracked(st, sess_, state_, ctx, carry, use_gang, use_prop):
        plan = made(st, sess_, state_, ctx, carry, use_gang, use_prop)
        seen["plans"] += 1
        call = plan.__call__

        def checked(dirty=None):
            before = tuple(x.clone() for x in plan.out)
            got = call(dirty)
            if dirty is not None and not bool(dirty):
                seen["clear"] += 1
                assert all(torch.equal(a, b) for a, b in zip(got, before))
            else:
                Vp, R = ctx.cres.shape
                want = k13.round_products_plain(
                    st, ctx, carry.cand, carry.rank_nj, carry.cum_nq, state_.job_ready_cnt,
                    sess_.min_avail, state_.queue_alloc, use_gang, use_prop,
                    k13.new_products(Vp, st.num_nodes, R, "cpu"))
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
            seen["launches"] += 1
            return got

        return _Wrapped(plan, checked)

    monkeypatch.setattr(port_pre, "_products_plan", tracked)
    port = port_pre.reclaim_action(pst, sess, state, TIERS, turn_batch=turn_batch)
    monkeypatch.undo()
    canon = port_pre.reclaim_action(pst, sess, state, TIERS)
    for f in ("task_status", "task_node", "evicted_for", "job_ready_cnt", "queue_alloc"):
        assert torch.equal(getattr(port, f), getattr(canon, f)), f
    assert seen["plans"] == 1 and seen["launches"] > port.rounds
    assert (seen["clear"] > 0) == (turn_batch is True)
    assert int((port.evicted_for != -1).sum()) > 0


class _Wrapped:
    """A plan whose launches go through ``call`` (a bound method cannot
    be replaced on the instance for the call syntax)."""

    def __init__(self, plan, call):
        self._plan, self._call = plan, call
        self.out = plan.out

    def __call__(self, dirty=None):
        return self._call(dirty)


def test_round_products_plan_cpu_is_the_plain_version():
    pst = _q64_world()
    sess, state = port_cycle.open_session(pst, TIERS)
    ctx = port_pre._canon_ctx(pst, sess)
    carry = port_pre._canon_seed(pst, state, ctx)
    plan = port_pre._products_plan(pst, sess, state, ctx, carry, True, True)
    Vp, R = ctx.cres.shape
    want = k13.round_products_plain(pst, ctx, carry.cand, carry.rank_nj, carry.cum_nq,
                                    state.job_ready_cnt, sess.min_avail, state.queue_alloc,
                                    True, True, k13.new_products(Vp, pst.num_nodes, R, "cpu"))
    got = plan()
    assert got is plan.out and all(torch.equal(a, b) for a, b in zip(got, want))
    # the padding past the last block: no eligible slot, zero scan rows
    V = int(pst.rv_block_start[-1])
    assert V < Vp and not bool(got[0][V:].any()) and not bool(got[2][V:].any())


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,S", [(0, 5), (1025, 40), (102_400, 1024), (51_200, 5120)])
def test_segment_sum_forms_on_card(cuda_device, n, S):
    """The count route (one launch), the sums over a held order and
    ordered_sum on the card equal the plain versions."""
    rng = np.random.default_rng(n)
    val = t((rng.standard_normal((n, 5)) * 1e3).astype(np.float32))
    idx = t(rng.integers(-2, S + 2, n).astype(np.int32))
    dval, didx = val.to(cuda_device), idx.to(cuda_device)
    want = k4.segment_sum_plain(val, idx, S)
    before = k4.segment_sum.launches
    assert torch.equal(k4.segment_sum(dval, didx, S).cpu(), want)
    assert k4.segment_sum.launches == before + 1
    order = k4.segment_order(didx, S)
    before = k4.segment_sum.launches
    assert torch.equal(k4.segment_sum(dval, didx, S, order=order).cpu(), want)
    assert k4.segment_sum.launches == before + (1 if S else 0)
    base = t((rng.standard_normal((S, 5)) * 1e6).astype(np.float32))
    out = base.to(cuda_device)
    k4.segment_sum(dval, didx, S, out=out)
    assert torch.equal(out.cpu(), k4.segment_sum_plain(val, idx, S, out=base.clone()))
    ival = t(rng.integers(-50, 50, (n, 3)).astype(np.int32))
    assert torch.equal(k4.segment_sum(ival.to(cuda_device), didx, S).cpu(),
                       k4.segment_sum_plain(ival, idx, S))
    if n:
        assert torch.equal(k4.ordered_sum(dval).cpu(),
                           k4.segment_sum_plain(val, torch.zeros(n, dtype=torch.int32), 1)[0])


@pytest.mark.cuda
def test_round_products_plan_on_card(cuda_device):
    """The plan's launches back to back, a clear dirty flag, and the
    batched engine through it, equal the CPU."""
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        pst = _q64_world(dev)
        sess, state = port_cycle.open_session(pst, TIERS)
        ctx = port_pre._canon_ctx(pst, sess)
        carry = port_pre._canon_seed(pst, state, ctx)
        plan = port_pre._products_plan(pst, sess, state, ctx, carry, True, True)
        first = tuple(x.clone() for x in plan())
        carry.cand[::3] = False
        plan(torch.zeros(1, dtype=torch.bool, device=dev))
        kept = all(torch.equal(a, b) for a, b in zip(plan.out, first))
        second = tuple(x.clone() for x in plan(torch.ones(1, dtype=torch.bool, device=dev)))
        run = port_pre.reclaim_action(pst, sess, state, TIERS, turn_batch=True)
        out[dev.type] = (first, second, kept, run)
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu[2] and cpu[2]
    for a, b in zip(gpu[0] + gpu[1], cpu[0] + cpu[1]):
        assert torch.equal(a.cpu(), b)
    for f in dataclasses.fields(cpu[3]):
        x, y = getattr(gpu[3], f.name), getattr(cpu[3], f.name)
        assert (torch.equal(x.cpu(), y) if isinstance(y, torch.Tensor) else x == y), f.name
