"""Cluster model, snapshot packs, the incremental arena and the
simulation harness."""
from .arena import ArenaDivergence, PackMeta, SnapshotArena
from .sim import (
    BindFailure,
    BindIntent,
    EvictIntent,
    FakeBinder,
    FakeEvictor,
    FakeVolumeBinder,
    SimCluster,
    generate_cluster,
)
from .snapshot import (
    HostPack, Snapshot, SnapshotIndex, SnapshotTensors, build_snapshot, from_numpy,
    set_sticky_buckets,
)
from .synth import SynthIndex, build_synthetic_arrays, build_synthetic_snapshot

__all__ = [
    "ArenaDivergence",
    "BindFailure",
    "BindIntent",
    "EvictIntent",
    "FakeBinder",
    "FakeEvictor",
    "FakeVolumeBinder",
    "HostPack",
    "PackMeta",
    "SimCluster",
    "Snapshot",
    "SnapshotArena",
    "SnapshotIndex",
    "SnapshotTensors",
    "SynthIndex",
    "build_snapshot",
    "build_synthetic_arrays",
    "build_synthetic_snapshot",
    "from_numpy",
    "generate_cluster",
    "set_sticky_buckets",
]
