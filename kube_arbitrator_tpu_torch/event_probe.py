"""How often torch.profiler loses the device record of a one-kernel call,
and which call's.

    python -m kube_arbitrator_tpu_torch.event_probe [--profiles 100] [--calls 20]

chip_smoke.py counts a plan's device events a call under torch.profiler
and requires exactly one.  This probe profiles ``--calls`` back-to-back
calls ``--profiles`` times for three one-kernel calls (K20's plan at
_reclaim_fast's [51,200, 3], its masked plan at [51,200, 4], and a
16-float ``Tensor.add_``), in four forms: ``plain`` (the calls alone),
``spin_first`` (a ``torch.cuda._sleep`` kernel launched and waited for
first, inside the profile, its own event left out), ``by_launch`` (host
and device activity, each launch matched to its kernel by correlation
id: which launches lost their record), and ``records`` (chip_smoke.py's
form: spin first with host and device activity, each profile counted
as whole, short of device events with its spin seen, or with its spin
lost, and with no device event at all).
Prints one JSON line per call and form.  Needs the GPU.
"""
from __future__ import annotations

import argparse
import collections
import json
from typing import List, Optional

import torch

SPIN = "spin_kernel"  # torch.cuda._sleep's kernel


def _device_events(prof) -> list:
    return [e for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]


def plain(fn, calls: int) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return len(_device_events(prof))


def spin_first(fn, calls: int) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2000)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(SPIN not in e.name for e in _device_events(prof))


def by_launch(fn, calls: int) -> List[int]:
    """The indices of the launches whose kernel record is missing."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches, kernels = [], set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.add(e.correlation_id())
        elif e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches.append(e.correlation_id())
    return [i for i, c in enumerate(sorted(launches)) if c not in kernels]


def records(fn, calls: int) -> str:
    """How one profile in chip_smoke.py's form came out: ``whole`` (the
    spin's event there, as many device events as host launch records),
    ``short`` (the spin's event there, the two counts differ),
    ``spin_lost`` or ``none`` (no device event at all)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2000)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = _device_events(prof)
    host = [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA]
    host = max(sum(n.startswith(("cudaLaunch", "cudaMemset", "cudaMemcpy")) for n in host),
               sum(n.startswith(("cuLaunch", "cuMemset", "cuMemcpy")) for n in host)) - 1
    spin = sum(SPIN in e.name for e in dev)
    if not dev:
        return "none"
    if not spin:
        return "spin_lost"
    return "whole" if len(dev) - spin == host else "short"


def main(argv: Optional[List[str]] = None) -> int:
    from .ops.kernels import ordered_scan as k20

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profiles", type=int, default=100)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    V = 51_200
    x = torch.rand((V, 4), device=dev)
    x3 = x[:, :3].contiguous()
    mask = torch.rand(V, device=dev) < 0.3
    plan, mplan = k20.OrderedScanPlan(V, 3, dev), k20.OrderedScanPlan(V, 4, dev, rows=x)
    small = torch.zeros(16, device=dev)
    fns = {"ordered_scan [51200, 3]": lambda: plan(x=x3),
           "ordered_scan masked [51200, 4]": lambda: mplan(mask=mask),
           "Tensor.add_ [16]": lambda: small.add_(1)}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    counts = {(n, f): collections.Counter() for n in fns for f in ("plain", "spin_first")}
    missing = {n: collections.Counter() for n in fns}
    lossy = collections.Counter()
    outcomes = {n: collections.Counter() for n in fns}
    for _ in range(args.profiles):  # the forms interleaved, profile by profile
        for name, fn in fns.items():
            counts[(name, "plain")][plain(fn, args.calls)] += 1
            counts[(name, "spin_first")][spin_first(fn, args.calls)] += 1
            lost = by_launch(fn, args.calls)
            lossy[name] += bool(lost)
            missing[name].update(lost)
            outcomes[name][records(fn, args.calls)] += 1
    for name in fns:
        for form in ("plain", "spin_first"):
            print(json.dumps(dict(call=name, form=form, profiles=args.profiles, calls=args.calls,
                                  events=dict(sorted(counts[(name, form)].items())))))
        print(json.dumps(dict(call=name, form="by_launch", profiles=args.profiles,
                              calls=args.calls, lossy_profiles=lossy[name],
                              missing_launch_index=dict(sorted(missing[name].items())))))
        print(json.dumps(dict(call=name, form="records", profiles=args.profiles,
                              calls=args.calls, outcomes=dict(sorted(outcomes[name].items())))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
