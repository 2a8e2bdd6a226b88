"""The optimistic reclaim engine's worlds at full width on the CPU: the
port against the JAX package, each world under
``reclaim_optimistic, allocate, backfill, preempt`` (the default tiers,
100 tasks per job, the default ``fit_fraction`` 1.2, seed 42):

* ``q512_evict``: 50,000 pods x 5,000 nodes, 512 queues, 50% of jobs
  running (the reference bench's ``full_actions_q512@50000x5000``);
* ``rounds_q4``: 20,000 x 2,000, 4 queues, 70% running
  (``full_actions_rounds_q4@20000x2000``).

Slow (minutes: the reference compiles and runs each staged cycle at full
width), so tier-1 leaves it out:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_reclaim_fullwidth.py -m slow -s

Both packages run ``schedule_cycle_staged``; every integer decision field
and every stage's counters (rounds, gated rounds, claim conflicts) must
be equal.  It prints the counts, the digest and the reclaim counters
that chip_smoke.py holds the card's run of the same worlds against
(``Q512_WORLD_42``, ``ROUNDS_Q4_WORLD_42``).  Node capacities are
fractional at 1.2, so the session's f32 sums may differ in low bits
(ROADMAP queue C); the f32 fields are reported, not required.
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

ACTIONS = ("reclaim_optimistic", "allocate", "backfill", "preempt")
WORLDS = {
    "q512_evict": dict(num_tasks=50_000, num_nodes=5_000, num_queues=512, tasks_per_job=100,
                       seed=42, running_fraction=0.5),
    "rounds_q4": dict(num_tasks=20_000, num_nodes=2_000, num_queues=4, tasks_per_job=100,
                      seed=42, running_fraction=0.7),
}
F32_FIELDS = ("node_idle", "queue_deserved", "queue_alloc")


def decision_digest(bind_mask: np.ndarray, evict_mask: np.ndarray) -> str:
    """sha256[:16] of the bound and evicted task ordinals (the same
    function as chip_smoke.py's)."""
    h = hashlib.sha256(np.nonzero(bind_mask)[0].astype(np.int32).tobytes())
    h.update(b"|")
    h.update(np.nonzero(evict_mask)[0].astype(np.int32).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.slow
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_fullwidth_reclaim_world_matches_reference(world):
    st = ref_synth(**WORLDS[world]).tensors
    arrays = {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}
    t0 = time.perf_counter()
    ref, ref_t = ref_cycle.schedule_cycle_staged(st, actions=ACTIONS)
    np.asarray(ref.evict_mask)
    t1 = time.perf_counter()
    port, port_t = port_cycle.schedule_cycle_staged(from_numpy(arrays, "cpu"), actions=ACTIONS)
    t2 = time.perf_counter()
    diverged = [
        f.name for f in dataclasses.fields(port)
        if f.name not in F32_FIELDS
        and not np.array_equal(np.asarray(getattr(ref, f.name)), getattr(port, f.name).numpy())
    ]
    f32_equal = {
        f: bool(np.array_equal(np.asarray(getattr(ref, f)), getattr(port, f).numpy()))
        for f in F32_FIELDS
    }
    bind, evict = port.bind_mask.numpy(), port.evict_mask.numpy()
    phases = np.bincount(port.evict_phase.numpy()[evict], minlength=4).tolist()
    counters = {x[0]: x[3:] for x in port_t if x[3] is not None}
    print(f"\n{world}: reference {t1 - t0:.1f} s, port {t2 - t1:.1f} s (CPU); binds "
          f"{int(bind.sum())}, evicts by phase {phases}, digest {decision_digest(bind, evict)}, "
          f"(rounds, rounds_gated, claim_conflicts) per action {counters}, "
          f"f32 fields equal {f32_equal}")
    assert not diverged, f"integer decision fields diverged: {diverged}"
    assert [x[0] for x in port_t] == [x[0] for x in ref_t]
    assert [x[3:] for x in port_t] == [x[3:] for x in ref_t]
    assert phases[3] > 0 and counters["reclaim_optimistic"][2] > 0
