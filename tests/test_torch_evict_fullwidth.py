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
