"""Multi-resource vector arithmetic with kube-batch's epsilon semantics
(the port's copy of kube_arbitrator_tpu/api/resource.py).

Semantics parity: reference ``pkg/scheduler/api/resource_info.go:26-168``.
The reference tracks MilliCPU / Memory / MilliGPU as float64 plus a
``MaxTaskNum`` pod-count cap that is deliberately excluded from arithmetic.
Comparisons are epsilon-slacked (10 milli-cpu, 10 MiB, 10 milli-gpu,
``resource_info.go:54-56``) so tiny fragments never flip fairness decisions.

A Resource here is a length-``NUM_RESOURCES`` numpy vector so host-side
accounting and the pack share one layout: axis order [cpu_milli,
memory_bytes, gpu_milli, attachments].  In device units the epsilon is
uniformly ``cache/snapshot.DEVICE_EPSILON``, so host and device agree on
"fits".
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

# Resource axis order. Everything in the framework — host accounting, snapshot
# tensors, kernels — uses this order.  The 4th axis is attachable-volume
# capacity: the reference routes volume limits through the k8s volumebinder
# (cache.go:230-238); here capacity dimensions are just resource axes, so
# every fit/claim kernel enforces attach limits with no extra code.  It is
# NOT a fairness axis — DRF/proportion read only the first
# ``NUM_FAIR_RESOURCES`` (the reference's Resource has exactly
# cpu/memory/gpu, resource_info.go:26-40).
CPU = 0
MEMORY = 1
GPU = 2
ATTACH = 3
NUM_RESOURCES = 4
NUM_FAIR_RESOURCES = 3
RESOURCE_NAMES = ("cpu", "memory", "gpu", "attachments")

# Epsilon slack per resource: 10 milli-cpu, 10 MiB, 10 milli-gpu
# (reference resource_info.go:54-56); attachments are integral so the
# slack is a tenth of a volume.
EPSILON = np.array([10.0, 10.0 * 1024 * 1024, 10.0, 0.1], dtype=np.float64)


def zeros() -> np.ndarray:
    return np.zeros(NUM_RESOURCES, dtype=np.float64)


def make(
    cpu_milli: float = 0.0,
    memory: float = 0.0,
    gpu_milli: float = 0.0,
    attach: float = 0.0,
) -> np.ndarray:
    return np.array([cpu_milli, memory, gpu_milli, attach], dtype=np.float64)


def is_empty(r: np.ndarray) -> bool:
    """True when every component is below epsilon (resource_info.go:75-77)."""
    return bool(np.all(r < EPSILON))


def less(a: np.ndarray, b: np.ndarray) -> bool:
    """Strict component-wise less (resource_info.go:138-140)."""
    return bool(np.all(a < b))


def less_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Epsilon-slacked <=: each component a_r < b_r + eps_r.

    Equivalent to the reference's ``a < b || |b-a| < eps`` per component
    (resource_info.go:142-146).
    """
    return bool(np.all(a < b + EPSILON))


def fit_delta(avail: np.ndarray, req: np.ndarray) -> np.ndarray:
    """Per-resource shortfall signal (resource_info.go:116-129).

    For each requested component, returns avail - (req + eps); negative
    components are insufficient resources.  Components not requested are
    passed through unchanged.
    """
    out = avail.astype(np.float64).copy()
    requested = req > 0
    out[requested] -= req[requested] + EPSILON[requested]
    return out


def sub_checked(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a - b, raising if b does not epsilon-fit in a (resource_info.go:100-110)."""
    if not less_equal(b, a):
        raise ValueError(f"Resource not sufficient: {a} sub {b}")
    return a - b


def share(alloc: float, total: float) -> float:
    """alloc/total with the reference's zero-total convention
    (api/helpers/helpers.go:38-48): if total == 0, share is 1 when alloc>0
    else 0."""
    if total == 0:
        return 1.0 if alloc > 0 else 0.0
    return alloc / total


def dominant_share(alloc: np.ndarray, total: np.ndarray) -> float:
    """DRF dominant share: max_r share(alloc_r, total_r) (drf.go:150-160)."""
    # DRF dominance is over the reference's resource set only
    return max(share(float(alloc[i]), float(total[i])) for i in range(NUM_FAIR_RESOURCES))


def res_min(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Component-wise min (api/helpers/helpers.go:25-36)."""
    return np.minimum(a, b)


def sum_resources(rs: Iterable[np.ndarray]) -> np.ndarray:
    out = zeros()
    for r in rs:
        out += r
    return out


@dataclasses.dataclass
class ResourcePool:
    """Mutable named resource accumulator used by host-side accounting."""

    vec: np.ndarray = dataclasses.field(default_factory=zeros)

    def add(self, r: np.ndarray) -> "ResourcePool":
        self.vec = self.vec + r
        return self

    def sub(self, r: np.ndarray) -> "ResourcePool":
        self.vec = sub_checked(self.vec, r)
        return self

    def clone(self) -> "ResourcePool":
        return ResourcePool(self.vec.copy())
