from .snapshot import Snapshot, SnapshotTensors, from_numpy
from .synth import SynthIndex, build_synthetic_arrays, build_synthetic_snapshot

__all__ = [
    "Snapshot", "SnapshotTensors", "SynthIndex", "build_synthetic_arrays",
    "build_synthetic_snapshot", "from_numpy",
]
