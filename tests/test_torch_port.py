"""The PyTorch port's boundaries: it imports nothing of JAX or of the JAX
package, its entry points default to the GPU and raise without one, its
pack refuses what this slice cannot decide, and its decode and command
line agree with the reference's."""
import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.api import PodAffinityTerm
from kube_arbitrator_tpu.cache import SimCluster, build_snapshot
from kube_arbitrator_tpu.cache.decode import decode_batch
from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu_torch import cli, resolve_device
from kube_arbitrator_tpu_torch.cache.decode import decode_binds
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_snapshot
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle

REPO = Path(__file__).resolve().parent.parent
GB = 1024**3


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    return sorted((REPO / "kube_arbitrator_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "kube_arbitrator_tpu"), f"{path.name} imports {mod}"


def test_device_seam(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        build_synthetic_snapshot(64, 16, num_queues=2, tasks_per_job=8)
    with pytest.raises(RuntimeError):
        cli.main(["--tasks", "64", "--nodes", "16", "--cycles", "1"])
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_from_numpy_checks_and_refusals():
    sim = SimCluster()
    sim.add_queue("q")
    sim.add_node("n1", cpu_milli=4000, memory=8 * GB, labels={"zone": "a"})
    j = sim.add_job("j", queue="q")
    sim.add_task(j, 1000, GB, name="t0")
    arrays = pack_arrays(build_snapshot(sim.cluster).tensors)
    assert any(k.startswith("rv_") for k in arrays)  # ignored
    st = from_numpy(arrays, "cpu")
    assert st.task_resreq.dtype == torch.float32 and st.task_valid.dtype == torch.bool
    bad = dict(arrays, node_idle=arrays["node_idle"].astype(np.float64))
    with pytest.raises(TypeError, match="node_idle"):
        from_numpy(bad, "cpu")
    with pytest.raises(ValueError, match="missing"):
        from_numpy({k: v for k, v in arrays.items() if k != "job_queue"}, "cpu")
    sim.add_task(j, 500, GB, name="t1", labels={"app": "x"},
                 affinity=[PodAffinityTerm(match_labels=(("app", "x"),), topology_key="zone")])
    with pytest.raises(NotImplementedError, match="slice 4"):
        from_numpy(pack_arrays(build_snapshot(sim.cluster).tensors), "cpu")


@pytest.mark.parametrize("caps", [None, (64, 8)])
def test_decode_matches_reference(caps):
    """The same bind pairs as the reference's dense decode, from the
    compact lists and from the dense fallback (caps forced small)."""
    snap = ref_synth(num_tasks=400, num_nodes=40, num_queues=2, tasks_per_job=20, seed=3)
    ref = ref_cycle.schedule_cycle(snap.tensors)
    want = [(b.task_uid, b.node_name) for b in decode_batch(snap, ref).binds]
    dec = port_cycle.schedule_cycle(from_numpy(pack_arrays(snap.tensors), "cpu"), decode_caps=caps)
    binds = decode_binds(snap.index, dec)
    assert binds.overflowed == (caps is not None)
    assert binds.pairs() == want and len(want) > 64


def test_cli_runs_on_cpu(capsys):
    assert cli.main(["--tasks", "300", "--nodes", "30", "--queues", "2",
                     "--tasks-per-job", "20", "--cycles", "2", "--device", "cpu", "--json"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["seed"] for r in rows] == [42, 43]
    assert all(r["binds"] > 0 and r["rounds"]["rounds.allocate"] > 0 for r in rows)
