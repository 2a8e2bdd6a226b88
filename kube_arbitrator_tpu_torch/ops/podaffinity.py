"""Pod (anti-)affinity as per-term domain counts (the port of
kube_arbitrator_tpu/ops/podaffinity.py).

The relational predicate factors through topology domains and pod label
classes (cache/snapshot.py): per turn, the pods placed earlier this
cycle are counted per domain of each of the group's terms and added to
the pack's static counts, and the group's verdict per node is a gather.
Within the cycle this reproduces self-affinity seeding (a gang's first
batch lands in one domain, chosen by capacity), self-anti-affinity
spreading (one pod per domain, first node in packing order) and dynamic
symmetry (pods placed this cycle with anti terms block later matching
placements in their domains).

K11 computes the fit, K12 folds the seed and cap terms over a turn's
capacity rows; their plain versions live beside them in ops/kernels/.
"""
from __future__ import annotations

from ..cache.snapshot import pa_enabled
from .kernels.pa_fit import PaFitPlan, PodAffinityFit, pa_fit as pod_affinity_fit
from .kernels.pa_shape import PaShapePlan, apply_domain_cap, apply_seed, pa_shape

__all__ = [
    "PaFitPlan", "PaShapePlan", "PodAffinityFit", "apply_domain_cap", "apply_seed", "pa_enabled",
    "pa_shape", "pod_affinity_fit",
]
