"""PyTorch/CUDA port of kube_arbitrator_tpu's decision plane.

The JAX package ``kube_arbitrator_tpu`` is the reference; this package
carries its own copies of the pack, constants and synthetic world
generator and imports nothing from it (or from JAX).  Module names mirror
the reference so each counterpart is easy to find:

* ``cache/snapshot.py`` — :class:`SnapshotTensors` and ``from_numpy``;
* ``cache/synth.py``    — the synthetic world generator;
* ``ops/cycle.py``      — ``schedule_cycle`` (allocate + backfill);
* ``ops/kernels/``      — the hand-written CUDA kernels and their plain
  PyTorch versions.

Entry points run on the GPU unless the caller asks for the CPU
(:func:`resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
