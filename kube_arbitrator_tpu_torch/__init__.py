"""PyTorch/CUDA port of kube_arbitrator_tpu's decision plane.

The JAX package ``kube_arbitrator_tpu`` is the reference; this package
carries its own copies of the pack, constants and synthetic world
generator and imports nothing from it (or from JAX).  Module names mirror
the reference so each counterpart is easy to find:

* ``cache/snapshot.py`` — :class:`SnapshotTensors` and ``from_numpy``;
* ``cache/synth.py``    — the synthetic world generator;
* ``cache/arena.py``    — the epoch-keyed device-resident pack;
* ``ops/cycle.py``      — ``schedule_cycle`` (the conf's actions);
* ``ops/kernels/``      — the hand-written CUDA kernels and their plain
  PyTorch versions;
* ``framework/``        — ``TorchDecider``, the decider a scheduler's
  session calls, and the port's ``SchedulerConfig``.

Entry points run on the GPU unless the caller asks for the CPU
(:func:`resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
