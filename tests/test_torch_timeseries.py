"""The port's time-series ring and SLO burn monitors
(``kube_arbitrator_tpu_torch/utils/timeseries.py``) held against the
reference's (``kube_arbitrator_tpu/utils/timeseries.py``): the same
samples on the same fake clock give the same rows, burn rates, breach
fractions, firing pairs, status documents and metric families."""
import pytest

from kube_arbitrator_tpu.utils import timeseries as ref_ts
from kube_arbitrator_tpu.utils.metrics import MetricsRegistry as RefRegistry
from kube_arbitrator_tpu_torch.utils import timeseries as port_ts
from kube_arbitrator_tpu_torch.utils.metrics import MetricsRegistry as PortRegistry

WINDOWS = ((20.0, 5.0, 1.0), (60.0, 10.0, 2.0))
# (clock step s, latency ms): a calm stretch, an acute burn, recovery
SAMPLES = ([(1.0, 40.0)] * 12 + [(0.5, 250.0)] * 10 + [(1.0, 90.0), (1.0, 400.0)] * 6
           + [(2.0, 30.0)] * 20)


def _pair(mod, registry, clock, **kw):
    ring = mod.TimeSeriesRing(capacity=kw.pop("capacity", 4096), now_fn=lambda: clock[0])
    reg = registry()
    mon = mod.SloBurnMonitor(ring, slo_ms=100.0, budget=0.25, windows=WINDOWS, registry=reg,
                             min_samples=kw.pop("min_samples", 4))
    return ring, mon, reg


@pytest.mark.parametrize("capacity", [4096, 16])
def test_ring_and_burn_match_reference(capacity):
    clock = [1000.0]
    ref = _pair(ref_ts, RefRegistry, clock, capacity=capacity)
    port = _pair(port_ts, PortRegistry, clock, capacity=capacity)
    fired_any = False
    for step, ms in SAMPLES:
        clock[0] += step
        for ring, mon, _ in (ref, port):
            ring.sample({"cycle_ms": ms, "binds": 3})
        fired = [mon.check() for _, mon, _ in (ref, port)]
        assert fired[0] == fired[1]
        fired_any = fired_any or bool(fired[1])
        for window in (None, 5.0, 20.0, 60.0):
            assert ref[0].rows(window) == port[0].rows(window)
        assert ref[0].series("cycle_ms", 20.0) == port[0].series("cycle_ms", 20.0)
        for window in (5.0, 10.0, 20.0, 60.0):
            assert ref[1].burn_rate(window) == port[1].burn_rate(window)
            assert ref[1].breach_fraction(window) == port[1].breach_fraction(window)
        assert ref[1].status() == port[1].status()
    assert fired_any
    assert len(ref[0]) == len(port[0]) == min(capacity, len(SAMPLES))
    assert ref[2].render() == port[2].render()
    assert "slo_burn_alerts_total" in port[2].render()


def test_burn_pair_monitor_policy_is_shared():
    """A subclass with its own column and predicate (the reference's
    pattern for its fleet skew monitor) fires the same pairs in both."""
    clock = [0.0]

    def sub(mod):
        class Skew(mod.BurnPairMonitor):
            column = "skew"

            def _breaches(self, v):
                return v > 1.5

        ring = mod.TimeSeriesRing(now_fn=lambda: clock[0])
        return ring, Skew(ring, 0.5, ((10.0, 3.0, 1.0),), 3)

    ref, port = sub(ref_ts), sub(port_ts)
    fired = ([], [])
    for i in range(30):
        clock[0] += 1.0
        v = 2.0 if 8 <= i < 18 else 1.0
        for k, (ring, mon) in enumerate((ref, port)):
            ring.sample({"skew": v})
            fired[k].append(mon.check())
    assert fired[0] == fired[1]
    assert any(fired[1])
    with pytest.raises(ValueError):
        port_ts.BurnPairMonitor(port[0], 1.5, (), 1)
    with pytest.raises(ValueError):
        port_ts.SloBurnMonitor(port[0], slo_ms=0)
