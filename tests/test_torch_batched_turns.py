"""The port's evictive cycle over the reference's sequential-vs-batched
matrix (tests/test_batched_turns.py): loaded random clusters at
q in {8, 64, 512}, two seeds each.

Both packages thread their own state through reclaim, allocate, backfill
and preempt; after every action the port's state must equal the
reference's (the audit aux and ``evicted_for`` included), and so must
the round counts.  The port's preempt runs three ways from the same
entry state — the batched round with the round gate on (the default),
with it off, and the sequential turn loop — and all three must equal the
reference's batched round.  Integer device units keep every sum exact
(tolerance: none).
"""
import dataclasses
import functools

import numpy as np
import pytest

from kube_arbitrator_tpu.cache import build_snapshot, generate_cluster
from kube_arbitrator_tpu.ops import allocate as ref_alloc
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_pre

GB = 1024**3
FIELDS = (
    "task_status", "task_node", "evicted_for", "job_ready_cnt", "group_placed",
    "job_alloc", "queue_alloc", "node_num_tasks", "node_releasing", "node_ports",
    "evict_claimant", "evict_phase", "evict_round",
)
REF_TIERS = ref_ord.DEFAULT_TIERS
TIERS = port_ord.DEFAULT_TIERS
# the opt-in reclaim engines, by the reference's name, and their switch
RECLAIM_ENGINES = {"_reclaim_canon_batched": True, "_reclaim_canon_optimistic": "optimistic"}


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


@functools.lru_cache(maxsize=None)
def _ref():
    """Module-cached jitted reference stages: the matrix's worlds share
    their shapes per q, so each stage compiles once per q."""
    import jax

    t = REF_TIERS
    return {
        "open": jax.jit(lambda s: ref_cycle.open_session(s, t)),
        "reclaim": jax.jit(lambda st, se, s: ref_pre.reclaim_action(st, se, s, t)),
        "allocate": jax.jit(lambda st, se, s: ref_alloc.allocate_action(st, se, s, t)),
        "backfill": jax.jit(lambda st, se, s: ref_alloc.backfill_action(st, se, s, t)),
        "preempt": jax.jit(lambda st, se, s: ref_pre.preempt_action(st, se, s, t)),
        "commit": jax.jit(ref_cycle.commit_cycle),
        **{name: jax.jit(lambda st, se, s, n=name: getattr(ref_pre, n)(st, se, s, t, 100_000))
           for name in RECLAIM_ENGINES},
    }


def _world(q, seed):
    # the reference matrix's worlds: more jobs than queues, oversubscribed
    return generate_cluster(
        num_nodes=48, num_jobs=max(12, q + q // 8), tasks_per_job=4, num_queues=q,
        seed=seed, node_cpu_milli=4000, node_memory=8 * GB, running_fraction=0.5,
    )


def _assert_state_equal(ref, port, ctx):
    for f in FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert np.array_equal(a, b), f"{ctx}: {f} diverged"
    assert int(ref.rounds) == port.rounds, f"{ctx}: rounds {int(ref.rounds)} vs {port.rounds}"


def _entry_states(st):
    eng = _ref()
    sess, state = eng["open"](st)
    pst = from_numpy(pack_arrays(st), "cpu")
    psess, pstate = port_cycle.open_session(pst, TIERS)
    return eng, (sess, state), (pst, psess, pstate)


@pytest.mark.parametrize("q", [8, 64, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_evictive_matrix_matches_reference(q, seed):
    st = build_snapshot(_world(q, seed).cluster).tensors
    eng, (sess, state), (pst, psess, pstate) = _entry_states(st)
    # the opt-in reclaim engines from the cycle's entry state: equal to
    # the reference's engines of the same name (counters included) and
    # to the port's canon walk
    canon = port_pre.reclaim_action(pst, psess, pstate, TIERS)
    for name, switch in RECLAIM_ENGINES.items():
        ref = eng[name](st, sess, state)
        port = port_pre.reclaim_action(pst, psess, pstate, TIERS, turn_batch=switch)
        _assert_state_equal(ref, port, f"{name} q={q} seed={seed}")
        _assert_state_equal(ref, canon, f"canon vs {name} q={q} seed={seed}")
        assert (port.rounds_gated, port.claim_conflicts) == (
            int(ref.rounds_gated), int(ref.claim_conflicts)), f"{name} counters q={q}"
    for action, port_fn in (
        ("reclaim", port_pre.reclaim_action),
        ("allocate", port_alloc.allocate_action),
        ("backfill", port_alloc.backfill_action),
    ):
        state = eng[action](st, sess, state)
        pstate = port_fn(pst, psess, pstate, TIERS)
        _assert_state_equal(state, pstate, f"{action} q={q} seed={seed}")
    ref = eng["preempt"](st, sess, state)
    legs = {
        "gate on": port_pre.preempt_action(pst, psess, pstate, TIERS),
        "gate off": port_pre.preempt_action(pst, psess, pstate, TIERS, turn_batch=True,
                                            round_gate=False),
        "sequential": port_pre.preempt_action(pst, psess, pstate, TIERS, turn_batch=False),
    }
    for name, leg in legs.items():
        _assert_state_equal(ref, leg, f"preempt {name} q={q} seed={seed}")
    assert legs["gate on"].rounds_gated == int(ref.rounds_gated)
    assert legs["gate off"].rounds_gated == 0 and legs["sequential"].rounds_gated == 0
    dec = eng["commit"](st, sess, ref)
    pdec = port_cycle.commit_cycle(pst, psess, legs["gate on"])
    for f in dataclasses.fields(pdec):
        a, b = np.asarray(getattr(dec, f.name)), getattr(pdec, f.name).numpy()
        if f.name == "queue_deserved":
            # the water-fill's per-step grant sum over 64 / 512 queues is
            # reduced in another order by XLA than the port's slot order
            # (ROADMAP queue C): low bits only, rtol 1e-5; every
            # decision above is equal
            np.testing.assert_allclose(b, a, rtol=1e-5)
        else:
            assert np.array_equal(a, b), f.name
    # the evictive machinery ran, or the parity above is vacuous
    assert int(pdec.evict_count) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_round_gate_with_overflow_turns_matches_reference(monkeypatch, seed):
    """More active queues than the selection panel (TURN_PANEL pinned to
    2): overflow turns run the sequential turn and the per-queue verdict
    validity must force recomputes; gate on and off equal the reference."""
    monkeypatch.setattr(port_pre, "TURN_PANEL", 2)
    st = build_snapshot(_world(8, seed).cluster).tensors
    eng, (sess, state), (pst, psess, pstate) = _entry_states(st)
    ref = eng["preempt"](st, sess, state)
    for gate in (True, False):
        port = port_pre.preempt_action(pst, psess, pstate, TIERS, turn_batch=True, round_gate=gate)
        _assert_state_equal(ref, port, f"overflow gate={gate} seed={seed}")
    assert (port.evict_phase.numpy() > 0).sum() > 0


def test_panel_tiers_match_reference():
    """The compacted victim panels (T//8 and T//4 tiers, forced with
    ``panel_floor=1``) decide like the full-width one and like the
    reference's switch."""
    import jax

    for running, seed in ((0.08, 3), (0.2, 5)):
        st = build_snapshot(generate_cluster(
            num_nodes=32, num_jobs=24, tasks_per_job=80, num_queues=6, seed=seed,
            running_fraction=running,
        ).cluster).tensors
        eng, (sess, state), (pst, psess, pstate) = _entry_states(st)
        ref = jax.jit(lambda st, se, s: ref_pre.preempt_action(st, se, s, REF_TIERS, panel_floor=1))(
            st, sess, state
        )
        port = port_pre.preempt_action(pst, psess, pstate, TIERS, panel_floor=1)
        full = port_pre.preempt_action(pst, psess, pstate, TIERS)
        _assert_state_equal(ref, port, f"panel running={running}")
        _assert_state_equal(ref, full, f"full running={running}")
        assert (port.evicted_for.numpy() >= 0).any()
