"""PyTorch/CUDA port of kube_arbitrator_tpu: the scheduler loop and its
decision plane.

The JAX package ``kube_arbitrator_tpu`` is the reference; this package
carries its own copies of the object model, the pack builders, the
constants and the world generators and imports nothing from it (or from
JAX).  Module names mirror the reference so each counterpart is easy to
find:

* ``api/``              — the object model (TaskInfo ... ClusterInfo),
  resource vectors and the status lattice; ``options.py`` the
  process-wide server options;
* ``cache/sim.py``      — ``SimCluster`` (builders, columnar actuation,
  resync, GC) and ``generate_cluster``;
* ``cache/snapshot.py`` — ``build_snapshot`` (ClusterInfo -> host pack),
  :class:`SnapshotTensors` and ``from_numpy`` (host pack -> device);
* ``cache/arena.py``    — ``SnapshotArena`` (the delta-maintained host
  pack) and the epoch-keyed device-resident pack;
* ``cache/decode.py``   — decisions -> bind / evict columns;
* ``cache/synth.py``    — the synthetic world generator;
* ``ops/cycle.py``      — ``schedule_cycle`` (the conf's actions);
* ``ops/kernels/``      — the hand-written CUDA kernels and their plain
  PyTorch versions;
* ``ops/diagnostics.py`` — the "why not scheduled" messages;
* ``framework/``        — ``Scheduler`` and ``Session`` (snapshot ->
  ``TorchDecider`` -> decode -> actuation -> status write-back), the
  conf (YAML) and the registries;
* ``pipeline/``         — the pipelined executor (``Scheduler.run_pipelined``),
  its delta journal and the revalidate-or-discard gate;
* ``utils/``            — metrics, tracing, the flight recorder, the time
  series, the kernel profiler, the concurrency sanitizer; ``obs.py``
  serves them.

Entry points run on the GPU unless the caller asks for the CPU
(:func:`resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
