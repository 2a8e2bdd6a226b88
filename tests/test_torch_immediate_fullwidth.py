"""The immediate decision path at full width on the CPU: the port against
the JAX package on two synthetic worlds.

* ``pa_evict`` — 50k tasks x 5k nodes, 8 queues, 100 tasks per job, 50%
  of jobs running, ``fit_fraction`` 1.2, seed 42, with the pod-affinity
  mix of cache/synth.py (hostname / rack / zone domains), under
  kube-batch's documented conf (reclaim, allocate, backfill, preempt):
  the immediate allocate and backfill with the fit, seed and domain cap,
  preempt's sequential loop with the fit in the claim, ``_reclaim_fast``
  with the immediate decode.
* ``binpack`` — 100k tasks x 10k nodes (the allocate world), seed 42,
  nodeorder ``binpack``, allocate and backfill: the per-turn packing
  order at N = 10,240.

Slow (minutes: the reference runs the immediate turn loop at full width),
so tier-1 leaves it out:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_immediate_fullwidth.py -m slow -s

It prints the counts and digests that chip_smoke.py holds the card's
runs of the same worlds against (``PA_WORLD_42``, ``BINPACK_WORLD_42``).
Node capacities are fractional at 1.2, so f32 sums of the session may
differ from the reference in low bits (ROADMAP queue C); the test
requires every integer decision field equal and reports the f32 fields.
"""
import dataclasses
import hashlib
import time

import numpy as np
import pytest

from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord

FULL = ("reclaim", "allocate", "backfill", "preempt")
F32_FIELDS = ("node_idle", "queue_deserved", "queue_alloc")
WORLDS = {
    "pa_evict": (dict(num_tasks=50_000, num_nodes=5_000, num_queues=8, tasks_per_job=100,
                      seed=42, running_fraction=0.5, pod_affinity=True), "first_fit", FULL),
    "binpack": (dict(num_tasks=100_000, num_nodes=10_000, num_queues=8, tasks_per_job=100,
                     seed=42), "binpack", ("allocate", "backfill")),
}


def decision_digest(bind_mask: np.ndarray, evict_mask: np.ndarray) -> str:
    """sha256[:16] of the bound and evicted task ordinals (the same
    function as chip_smoke.py's)."""
    h = hashlib.sha256(np.nonzero(bind_mask)[0].astype(np.int32).tobytes())
    h.update(b"|")
    h.update(np.nonzero(evict_mask)[0].astype(np.int32).tobytes())
    return h.hexdigest()[:16]


def with_node_order(mod, policy):
    """The module's default tiers with the nodeorder plugin's policy."""
    tiers = list(mod.DEFAULT_TIERS)
    opt = mod.PluginOption.of("nodeorder", arguments=(("policy", policy),))
    tiers[1] = mod.Tier(plugins=tiers[1].plugins + (opt,))
    return tuple(tiers)


@pytest.mark.slow
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_fullwidth_immediate_world_matches_reference(world):
    kw, policy, actions = WORLDS[world]
    arrays, _ = build_synthetic_arrays(**kw)
    st = ref_snapshot.SnapshotTensors(
        **{k: v for k, v in arrays.items() if k != "rv_window"}, rv_window=arrays["rv_window"])
    t0 = time.perf_counter()
    ref = ref_cycle.schedule_cycle(st, tiers=with_node_order(ref_ord, policy), actions=actions)
    np.asarray(ref.evict_mask)
    t1 = time.perf_counter()
    port = port_cycle.schedule_cycle(from_numpy(arrays, "cpu"),
                                     tiers=with_node_order(port_ord, policy), actions=actions)
    t2 = time.perf_counter()
    diverged = [
        f.name for f in dataclasses.fields(port) if f.name not in F32_FIELDS
        and not np.array_equal(np.asarray(getattr(ref, f.name)), getattr(port, f.name).numpy())
    ]
    f32_equal = {
        f: bool(np.array_equal(np.asarray(getattr(ref, f)), getattr(port, f).numpy()))
        for f in F32_FIELDS
    }
    bind, evict = port.bind_mask.numpy(), port.evict_mask.numpy()
    phases = np.bincount(port.evict_phase.numpy()[evict], minlength=4).tolist()
    print(f"\n{world}: reference {t1 - t0:.1f} s, port {t2 - t1:.1f} s (CPU); binds "
          f"{int(bind.sum())}, evicts by phase {phases}, digest {decision_digest(bind, evict)}, "
          f"f32 fields equal {f32_equal}")
    assert not diverged, f"integer decision fields diverged: {diverged}"
    assert int(bind.sum()) > 0
    if world == "pa_evict":
        assert phases[1] > 0 and phases[3] > 0
