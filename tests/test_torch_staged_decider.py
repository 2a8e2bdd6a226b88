"""The port's staged decide and the kernel profiler, held against the JAX
package's on the CPU.

* ``TorchDecider("cpu")`` under a sampled trace (or with the kernel
  profiler on) decides through the staged runner and publishes
  ``last_action_rounds`` with the reference ``LocalDecider``'s keys and
  values (``<action>:gated`` and ``<action>:conflicts`` included) on an
  evictive world and a 512-queue world under ``reclaim_optimistic``,
  ``last_action_ms`` for every stage, and one ``kernel.<stage>`` span a
  stage; with observability off both dicts stay empty.  The evictive
  world's decisions are the unstaged cycle's.
* ``preempt_panel_width`` equals the reference's on the same state (a
  low ``panel_floor`` so each tier shows on small packs); the phase-A
  probe runs without writing the state.
* The profiler's ``/debug/kernels`` table: every stage measured, the CPU
  estimate (``device_ms`` 0, ``launches`` 0) and ``preempt:phase_a`` with
  ``panel_w``.
* ``turn_batch_fallback_total{action, reason}`` counts every staged
  cycle whose evictive fast engine is off, as the reference's does.

Packs come from the reference's host code; decisions and rounds are
integers, compared exactly.  The reference's decider is routed to
JAX-CPU without its native kernels (``platform.decision_route`` is
patched in this process), so it runs the program the port mirrors.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import kube_arbitrator_tpu.platform as ref_platform
from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.framework.conf import SchedulerConfig as RefConfig
from kube_arbitrator_tpu.framework.decider import LocalDecider
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_preempt
from kube_arbitrator_tpu.utils.tracing import tracer as ref_tracer
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.framework import SchedulerConfig, TorchDecider
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops import preempt as port_preempt
from kube_arbitrator_tpu_torch.utils.metrics import metrics
from kube_arbitrator_tpu_torch.utils.profiling import profiler
from kube_arbitrator_tpu_torch.utils.tracing import tracer

FULL = ("reclaim", "allocate", "backfill", "preempt")
OPT = ("reclaim_optimistic", "allocate", "backfill", "preempt")
# world -> (pack arguments, actions)
WORLDS = {
    "evictive": (dict(num_tasks=1000, num_nodes=100, num_queues=4, tasks_per_job=50, seed=0,
                      running_fraction=0.5, fit_fraction=1.5), FULL),
    "q512": (dict(num_tasks=1024, num_nodes=64, num_queues=512, tasks_per_job=2, seed=1,
                  running_fraction=0.5, fit_fraction=1.25), OPT),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU cycles are thousands of small torch ops: one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def planes_off():
    for tr in (tracer(), ref_tracer()):
        tr.enable(False)
        tr.reset()
    profiler().enable(False)
    profiler().reset()
    metrics().reset()
    yield
    for tr in (tracer(), ref_tracer()):
        tr.enable(False)
        tr.reset()
    profiler().enable(False)
    profiler().reset()


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


_PACKS = {}


def packs(name):
    """(reference pack, port host arrays, actions) of a world, built once."""
    if name not in _PACKS:
        kw, actions = WORLDS[name]
        ref = ref_synth(**kw).tensors
        _PACKS[name] = ref, pack_arrays(ref), actions
    return _PACKS[name]


def ref_staged_rounds(monkeypatch, name):
    """The reference LocalDecider's staged dicts on the world (JAX-CPU,
    no native kernels), under a sampled trace."""
    monkeypatch.setattr(ref_platform, "decision_route",
                        lambda *a: (contextlib.nullcontext(), None, False))
    ref, _, actions = packs(name)
    d = LocalDecider()
    tr = ref_tracer()
    tr.enable()
    with tr.activate("c000001-ref"):
        d.decide(ref, RefConfig(actions=actions, tiers=ref_ord.DEFAULT_TIERS))
    return d.last_action_ms, d.last_action_rounds


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_staged_rounds_equal_reference(monkeypatch, name):
    _, arrays, actions = packs(name)
    conf = SchedulerConfig(actions=actions, tiers=port_ord.DEFAULT_TIERS)
    d = TorchDecider("cpu")
    if name == "evictive":  # the unstaged decide, for its decisions
        plain, _ = d.decide(arrays, conf)
        assert d.last_action_ms == {} and d.last_action_rounds == {}
    tr = tracer()
    tr.enable()
    with tr.activate("c000001-port"):
        staged, _ = d.decide(arrays, conf)
    ref_ms, ref_rounds = ref_staged_rounds(monkeypatch, name)
    assert d.last_action_rounds == ref_rounds
    assert set(d.last_action_ms) == set(ref_ms) == {"open_session", *actions, "commit"}
    if name == "q512":
        assert any(k.endswith(":gated") for k in ref_rounds)
    spans = [s.name for s in tr.spans("c000001-port")]
    assert spans == [f"kernel.{s}" for s in ("open_session", *actions, "commit")]
    if name == "evictive":
        for f in dataclasses.fields(plain):
            assert np.array_equal(getattr(plain, f.name), getattr(staged, f.name)), f.name


def _open(name):
    ref, arrays, _ = packs(name)
    rs, rstate = ref_cycle._open_session_jit(ref, tiers=ref_ord.DEFAULT_TIERS)
    st = from_numpy(arrays, "cpu")
    ps, pstate = port_cycle.open_session(st, port_ord.DEFAULT_TIERS)
    return ref, (rs, rstate), st, (ps, pstate)


@pytest.mark.parametrize("floor", [64, 128, 1024])
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_preempt_panel_width_equals_reference(name, floor):
    ref, (rs, rstate), st, (ps, pstate) = _open(name)
    want = ref_preempt.preempt_panel_width(ref, rs, rstate, panel_floor=floor)
    assert port_preempt.preempt_panel_width(st, ps, pstate, panel_floor=floor) == want


def test_phase_a_probe_reads_once_and_writes_nothing():
    from kube_arbitrator_tpu_torch.ops import steps

    _, _, st, (sess, state) = _open("evictive")
    before = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
              if isinstance(getattr(state, f.name), torch.Tensor)}
    before = {k: v.clone() for k, v in before.items()}
    w = port_preempt.preempt_panel_width(st, sess, state, panel_floor=64)
    for gated in (False, True):
        r0 = steps.host_reads[0]
        out = port_preempt.phase_a_probe(st, sess, state, port_ord.DEFAULT_TIERS, gated=gated,
                                         panel_w=w)
        assert steps.host_reads[0] - r0 == 1
        assert out["trip"] >= 1
        assert gated == (out["victims"] == 0)
    for k, v in before.items():
        assert torch.equal(getattr(state, k), v), k


def test_kernel_profiler_table_and_fallback_counter():
    """One evictive staged cycle with the profiler on: every stage
    measured with its CPU estimate, the phase-A split, and the
    fallback counter where the pack keeps preempt off its batched
    engine (pod affinity)."""
    _, arrays, actions = packs("evictive")
    profiler().enable()
    d = TorchDecider("cpu")
    d.decide(arrays, SchedulerConfig(actions=actions, tiers=port_ord.DEFAULT_TIERS))
    table = profiler().table()["shapes"]
    (shape,) = table
    stages = table[shape]
    assert {"open_session", *actions, "commit"} <= set(stages)
    for s in ("open_session", *actions, "commit"):
        assert stages[s]["measured"]["count"] == 1
        assert stages[s]["device_ms"] == 0.0 and stages[s]["launches"] == 0
    split = stages["preempt:phase_a"]["estimate"]
    assert {"panel_w", "phase_a_full_ms", "phase_a_gated_ms"} <= set(split)
    assert stages["preempt"]["measured"]["rounds_total"] == d.last_action_rounds["preempt"]

    pa = build_synthetic_arrays(600, 60, num_queues=4, tasks_per_job=30, seed=9,
                                running_fraction=0.3, fit_fraction=1.0, pod_affinity=True)[0]
    from kube_arbitrator_tpu.ops.cycle import _record_fallback_reasons as ref_record
    from kube_arbitrator_tpu.utils.metrics import metrics as ref_metrics

    ref_metrics().reset()
    for _ in range(2):
        port_cycle._record_fallback_reasons(from_numpy(pa, "cpu"), port_ord.DEFAULT_TIERS, FULL)
        ref_record(ref_snapshot.SnapshotTensors(
            **{k: v for k, v in pa.items() if k != "rv_window"}, rv_window=pa["rv_window"]),
            ref_ord.DEFAULT_TIERS, FULL)
    for family in ("turn_batch_fallback_total",):
        got = {k: v for k, v in metrics()._counters.items() if k[0] == family}
        want = {k: v for k, v in ref_metrics()._counters.items() if k[0] == family}
        assert got == want and got
