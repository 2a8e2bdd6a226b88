"""Cluster model, snapshot packs, the incremental arena, the simulation
harness and the live-cluster plane (the fake apiserver, its REST shim and
the list/watch cache)."""
from .arena import ArenaDivergence, PackMeta, SnapshotArena
from .fakeapi import ApiError, FakeApiServer, GoneError
from .httpapi import HttpApiClient, serve_api
from .live import LiveCache
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
    "ApiError",
    "ArenaDivergence",
    "BindFailure",
    "BindIntent",
    "EvictIntent",
    "FakeBinder",
    "FakeEvictor",
    "FakeApiServer",
    "FakeVolumeBinder",
    "GoneError",
    "HostPack",
    "HttpApiClient",
    "LiveCache",
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
    "serve_api",
    "set_sticky_buckets",
]
