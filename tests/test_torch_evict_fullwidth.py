"""The evictive cycle at full width on the CPU: the port against the JAX
package on the 50k-task x 5k-node synthetic world (8 queues, 100 tasks
per job, 50% of jobs running, the default ``fit_fraction`` 1.2, seed 42)
under kube-batch's documented conf (reclaim, allocate, backfill,
preempt).

Slow (minutes: the reference compiles and runs the whole cycle at
T = 51,200), so tier-1 leaves it out:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_evict_fullwidth.py -m slow -s

It prints the counts and the digest that chip_smoke.py holds the card's
run of the same world against (``EVICT_WORLD_42``).  Node capacities are
fractional at 1.2, so f32 sums of the session (cluster totals, deserved)
may differ from the reference in low bits (ROADMAP queue C); the test
requires every integer decision field equal and reports the f32 fields.
"""
import dataclasses
import hashlib
import time

import numpy as np
import pytest

from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle

FULL = ("reclaim", "allocate", "backfill", "preempt")
WORLD = dict(num_tasks=50_000, num_nodes=5_000, num_queues=8, tasks_per_job=100, seed=42,
             running_fraction=0.5)
F32_FIELDS = ("node_idle", "queue_deserved", "queue_alloc")


def decision_digest(bind_mask: np.ndarray, evict_mask: np.ndarray) -> str:
    """sha256[:16] of the bound and evicted task ordinals (the same
    function as chip_smoke.py's)."""
    h = hashlib.sha256(np.nonzero(bind_mask)[0].astype(np.int32).tobytes())
    h.update(b"|")
    h.update(np.nonzero(evict_mask)[0].astype(np.int32).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.slow
def test_fullwidth_evictive_world_matches_reference():
    st = ref_synth(**WORLD).tensors
    arrays = {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}
    t0 = time.perf_counter()
    ref = ref_cycle.schedule_cycle(st, actions=FULL)
    np.asarray(ref.evict_mask)
    t1 = time.perf_counter()
    port = port_cycle.schedule_cycle(from_numpy(arrays, "cpu"), actions=FULL)
    t2 = time.perf_counter()
    diverged = []
    for f in dataclasses.fields(port):
        if f.name in F32_FIELDS:
            continue
        if not np.array_equal(np.asarray(getattr(ref, f.name)), getattr(port, f.name).numpy()):
            diverged.append(f.name)
    f32_equal = {
        f: bool(np.array_equal(np.asarray(getattr(ref, f)), getattr(port, f).numpy()))
        for f in F32_FIELDS
    }
    bind, evict = port.bind_mask.numpy(), port.evict_mask.numpy()
    phases = np.bincount(port.evict_phase.numpy()[evict], minlength=4).tolist()
    print(f"\nreference {t1 - t0:.1f} s, port {t2 - t1:.1f} s (CPU); binds {int(bind.sum())}, "
          f"evicts by phase {phases}, digest {decision_digest(bind, evict)}, "
          f"f32 fields equal {f32_equal}")
    assert not diverged, f"integer decision fields diverged: {diverged}"
    assert phases[1] > 0 and phases[3] > 0


# The priority-mix evictive world (cache/synth.py ``priority_mix``): 64
# queues, capacity equal to the demand, seed 45 — preempt evicts in both
# phases and gates a round.  chip_smoke.py pins its counts and digest as
# ``MIX_WORLD_45``.  The reference gets the port synth's arrays.
MIX_WORLD = dict(num_tasks=50_000, num_nodes=5_000, num_queues=64, tasks_per_job=100, seed=45,
                 running_fraction=0.5, fit_fraction=1.0)


@pytest.mark.slow
def test_fullwidth_priority_mix_world_matches_reference():
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays

    arrays, _ = build_synthetic_arrays(**MIX_WORLD, priority_mix=True)
    st = dataclasses.replace(ref_synth(**MIX_WORLD).tensors, **arrays)
    t0 = time.perf_counter()
    ref = ref_cycle.schedule_cycle(st, actions=FULL)
    np.asarray(ref.evict_mask)
    t1 = time.perf_counter()
    stats = {}
    port = port_cycle.schedule_cycle(from_numpy(arrays, "cpu"), actions=FULL, stats=stats)
    t2 = time.perf_counter()
    diverged = [f.name for f in dataclasses.fields(port) if f.name not in F32_FIELDS
                and not np.array_equal(np.asarray(getattr(ref, f.name)), getattr(port, f.name).numpy())]
    f32_equal = {f: bool(np.array_equal(np.asarray(getattr(ref, f)), getattr(port, f).numpy()))
                 for f in F32_FIELDS}
    bind, evict = port.bind_mask.numpy(), port.evict_mask.numpy()
    phases = np.bincount(port.evict_phase.numpy()[evict], minlength=4).tolist()
    print(f"\nreference {t1 - t0:.1f} s, port {t2 - t1:.1f} s (CPU); binds {int(bind.sum())}, "
          f"evicts by phase {phases}, digest {decision_digest(bind, evict)}, preempt rounds "
          f"{stats['rounds.preempt']} (gated {stats['rounds_gated.preempt']}), "
          f"f32 fields equal {f32_equal}")
    assert not diverged, f"integer decision fields diverged: {diverged}"
    assert phases[1] > 0 and phases[2] > 0 and phases[3] > 0
    assert stats["rounds_gated.preempt"] > 0


# A priority-mix world where the standing f32 difference decides
# (ROADMAP queue C): fractional capacity at 16 queues, fit 0.75, seed 44.
FRACTIONAL_MIX_WORLD = dict(MIX_WORLD, num_queues=16, fit_fraction=0.75, seed=44)


@pytest.mark.slow
def test_fullwidth_fractional_mix_world_differs_in_session_sums_only():
    """The session opens with every integer field equal to the
    reference's; the f32 cluster sums may differ (XLA's reduction order
    against the port's slot order), and here that parts allocate.  Prints
    the differences the ROADMAP's standing entry quotes."""
    import jax

    from kube_arbitrator_tpu.ops.ordering import DEFAULT_TIERS as REF_TIERS
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as PORT_TIERS

    arrays, _ = build_synthetic_arrays(**FRACTIONAL_MIX_WORLD, priority_mix=True)
    st = dataclasses.replace(ref_synth(**FRACTIONAL_MIX_WORLD).tensors, **arrays)
    pst = from_numpy(arrays, "cpu")
    rs, rstate = jax.jit(lambda s: ref_cycle.open_session(s, REF_TIERS))(st)
    ps, pstate = port_cycle.open_session(pst, PORT_TIERS)
    f32_diff = {}
    for f in dataclasses.fields(ps):
        a, b = getattr(rs, f.name, None), getattr(ps, f.name)
        if a is None or not hasattr(b, "numpy"):
            continue
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == "f":
            if not np.array_equal(a, b):
                f32_diff[f.name] = float(np.abs(a.astype(np.float64) - b).max())
        else:
            assert np.array_equal(a, b), f"session field {f.name}"
    rounds = {}
    for act in ("reclaim", "allocate"):
        rstate = jax.jit(lambda s, se, a, act=act: ref_cycle.ACTION_KERNELS[act](s, se, a, REF_TIERS))(
            st, rs, rstate)
        pstate = port_cycle.ACTION_KERNELS[act](pst, ps, pstate, PORT_TIERS)
        rounds[act] = (int(rstate.rounds), pstate.rounds,
                       bool(np.array_equal(np.asarray(rstate.task_node), pstate.task_node.numpy())))
    print(f"\nsession f32 max |reference - port|: {f32_diff}; (reference rounds, port rounds, "
          f"task_node equal) by action: {rounds}")
