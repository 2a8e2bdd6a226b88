"""The host-read seam: every read of a device value that steers the
host's loops (a round's trip and progress flag, the water-fill's loop
condition, a panel width, a victim count, the optimistic window's
``ctl``) is a ``yield`` of the device tensors it needs, and the code
receives their host values back.

A function that reads is a generator of its reads, wrapped by
:func:`stepped`: calling it drives the generator alone (:func:`drive`,
one host read a yield, in the form the read had before the seam: one
tensor's ``tolist()``, or one stacked read of several), and its
``.steps`` is the generator itself, for a caller that is a generator
too (``yield from allocate_action.steps(...)``).  :func:`drive_many`
advances several generators in lockstep and serves each step of all of
them with one host read: K tenants' cycles pay the reads of their
longest member, not the sum (ops/cycle.batched_schedule_cycle).

Yielded tensors hold integers or bools, so one stacked i64 read carries
any mix of them exactly; a float raises.  ``host_reads`` counts the
reads that drive and drive_many made (a test's seam counter).
"""
from __future__ import annotations

import functools
from typing import Callable, Generator, List, Sequence

import torch

# host reads made by drive / drive_many since the process started
host_reads = [0]


def read(*xs: torch.Tensor):
    """Yield ``xs`` to whatever drives the generator; returns one host
    value per tensor (a Python scalar for a 0-d tensor, a list
    otherwise)."""
    vals = yield xs
    return vals


def _check(xs: Sequence[torch.Tensor]) -> None:
    for x in xs:
        if x.is_floating_point() or x.is_complex():
            raise TypeError(f"host-read seam: a {x.dtype} read; it carries integers and bools")


def _flat(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [x.reshape(-1).to(torch.int64) for x in xs]


def _split(flat: list, xs: Sequence[torch.Tensor], at: int = 0):
    out = []
    for x in xs:
        n = x.numel()
        out.append(flat[at] if x.dim() == 0 else flat[at:at + n])
        at += n
    return out, at


def _read_one(xs: Sequence[torch.Tensor]) -> list:
    """One host read of one generator's step."""
    _check(xs)
    host_reads[0] += 1
    if len(xs) == 1:
        return [xs[0].tolist()]
    return _split(torch.cat(_flat(xs)).tolist(), xs)[0]


def drive(gen: Generator):
    """Run ``gen`` alone: one host read a yield; returns its value."""
    try:
        xs = next(gen)
        while True:
            xs = gen.send(_read_one(xs))
    except StopIteration as stop:
        return stop.value


def drive_many(gens: Sequence[Generator]) -> list:
    """Run ``gens`` in lockstep on one thread: each step advances every
    unfinished generator to its next yield, then one host read serves the
    tensors all of them yielded.  Returns their values in order."""
    out = [None] * len(gens)
    live = {}
    for i, gen in enumerate(gens):
        try:
            live[i] = next(gen)
        except StopIteration as stop:
            out[i] = stop.value
    while live:
        order = list(live)
        for i in order:
            _check(live[i])
        flat = torch.cat([t for i in order for t in _flat(live[i])]).tolist()
        host_reads[0] += 1
        at = 0
        for i in order:
            vals, at = _split(flat, live[i], at)
            try:
                live[i] = gens[i].send(vals)
            except StopIteration as stop:
                out[i] = stop.value
                del live[i]
    return out


def stepped(fn: Callable[..., Generator]) -> Callable:
    """``fn`` (a generator function of host reads) as a function that
    drives it alone; ``fn`` itself stays reachable as ``.steps``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        return drive(fn(*args, **kwargs))

    run.steps = fn
    return run
