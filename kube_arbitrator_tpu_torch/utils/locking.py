"""Concurrency sanitizer shim: witnessed locks for the scheduler's threads
(the port's copy of kube_arbitrator_tpu/utils/locking.py).

The live plane is concurrent — the REST shim's handler threads, the
watch/ingest pump, the leader elector, the metrics registry's readers —
and a lock site read alone says nothing of the order in which threads
take locks.  This module checks that order at run time:
drop-in ``SanLock``/``SanRLock``/``SanCondition`` wrappers that record
per-thread acquisition order into a bounded witness graph and detect, at
runtime,

* **lock-order inversions** — thread 1 acquires A then B, thread 2
  acquires B then A (the classic deadlock precondition; witnessed even
  when the schedule happens not to deadlock),
* **hold-time SLO breaches** — a lock held longer than
  ``KAT_SANITIZE_HOLD_SLO_MS`` (slow work belongs *outside* locks; a
  long hold is a latent stall for every reader),
* **guarded-state mutation without the owning lock** — for (lock,
  fields) pairs registered via :func:`register_guarded`, any attribute
  rebind or container mutation from a thread that does not hold the lock
  (or, in single-writer mode, is not the owning thread).

The shim is **opt-in and zero-cost when off**: the :func:`Lock`/
:func:`RLock`/:func:`Condition` factories return the plain ``threading``
classes unless ``KAT_SANITIZE=1`` is set (or :func:`force_sanitize` was
called).  A test asserts the off-path returns the exact stdlib types.
``KAT_SANITIZE`` and ``KAT_SANITIZE_HOLD_SLO_MS`` are the reference's own
switches; the port reads the same names.

Every factory call passes a stable literal name (``"metrics.lock"``,
``"httpapi.api_lock"``, ...): lock names are how the witness graph and
its findings name a lock.  The port has no static lock-order analyzer
(the reference's ``analysis/`` plane); the witness graph stands alone.

This module must stay import-leaf (stdlib only): ``utils/metrics.py``
and everything above it construct their locks through these factories,
so importing them here would cycle.
"""
from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

# bounded witness: caps chosen so a runaway soak cannot grow the graph
# without bound (the report stays dumpable as a flight artifact)
MAX_EDGES = 1024
MAX_FINDINGS = 256
MAX_STACK_FRAMES = 6
DEFAULT_HOLD_SLO_MS = 500.0

_FORCE: Optional[bool] = None


def sanitize_enabled() -> bool:
    """True when the sanitizer shim is active for *new* lock construction."""
    if _FORCE is not None:
        return _FORCE
    return os.environ.get("KAT_SANITIZE", "") == "1"


def force_sanitize(on: Optional[bool]) -> Optional[bool]:
    """Override the ``KAT_SANITIZE`` env (``--sanitize``, race-soak runner).

    ``None`` restores env-driven behavior.  Returns the previous override
    so callers can restore it in a ``finally``.
    """
    global _FORCE
    prev = _FORCE
    _FORCE = on
    return prev


def _hold_slo_ms() -> float:
    try:
        return float(os.environ.get("KAT_SANITIZE_HOLD_SLO_MS", DEFAULT_HOLD_SLO_MS))
    except ValueError:
        return DEFAULT_HOLD_SLO_MS


def _short_stack(skip: int = 2) -> str:
    """Compact call-site tail: 'file:line fn <- file:line fn ...'."""
    frames = traceback.extract_stack()[: -skip][-MAX_STACK_FRAMES:]
    return " <- ".join(
        f"{os.path.basename(f.filename)}:{f.lineno} {f.name}" for f in reversed(frames)
    )


class LockWitness:
    """Bounded per-process witness graph of lock acquisition order.

    Thread-safe via one plain meta-lock; the meta-lock is a leaf (never
    held while acquiring a sanitized lock) so the witness itself cannot
    introduce an ordering edge.
    """

    def __init__(self) -> None:
        self._meta = threading.Lock()
        self._tls = threading.local()
        # (held, acquired) -> {"count": int, "stack": str}
        self.edges: Dict[Tuple[str, str], Dict[str, object]] = {}
        self.findings: List[Dict[str, object]] = []
        # canary allowlist: inversions expected by the race-soak canary
        # are witnessed (proving the shim sees them) but not findings
        self.expected_inversions: Set[FrozenSet[str]] = set()
        self._inversions_seen: Set[FrozenSet[str]] = set()
        self._guards_seen: Set[Tuple[str, str]] = set()
        self._holds_seen: Set[str] = set()

    # ---- per-thread held stack ----

    def _held(self) -> List[List[object]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    def _depth(self) -> Dict[str, int]:
        depth = getattr(self._tls, "depth", None)
        if depth is None:
            depth = {}
            self._tls.depth = depth
        return depth

    def held_by_current(self, name: str) -> bool:
        return self._depth().get(name, 0) > 0

    def held_names(self) -> List[str]:
        return [h[0] for h in self._held()]  # type: ignore[misc]

    # ---- hooks (called by SanLock/SanRLock) ----

    def on_acquire(self, name: str) -> None:
        depth = self._depth()
        n = depth.get(name, 0)
        depth[name] = n + 1
        if n:  # reentrant re-acquire (SanRLock): no new edges, no push
            return
        held = self._held()
        if held:
            stack = _short_stack(skip=3)
            with self._meta:
                for prior in held:
                    self._edge(prior[0], name, stack)  # type: ignore[arg-type]
        held.append([name, time.monotonic()])

    def on_release(self, name: str) -> None:
        depth = self._depth()
        n = depth.get(name, 0)
        if n > 1:
            depth[name] = n - 1
            return
        depth.pop(name, None)
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                _, t0 = held.pop(i)
                held_ms = (time.monotonic() - t0) * 1000.0  # type: ignore[operator]
                if held_ms > _hold_slo_ms() and name not in self._holds_seen:
                    with self._meta:
                        self._holds_seen.add(name)
                        self._finding(
                            kind="hold_slo",
                            lock=name,
                            held_ms=round(held_ms, 3),
                            stack=_short_stack(skip=3),
                        )
                return

    def on_guard(self, lock_name: str, obj_name: str, field: str, mode: str) -> None:
        key = (obj_name, field)
        with self._meta:
            if key in self._guards_seen:
                return
            self._guards_seen.add(key)
            self._finding(
                kind="guard",
                lock=lock_name,
                obj=obj_name,
                field=field,
                mode=mode,
                thread=threading.current_thread().name,
                stack=_short_stack(skip=3),
            )

    # ---- internals (meta-lock held) ----

    def _edge(self, a: str, b: str, stack: str) -> None:
        if a == b:
            return
        e = self.edges.get((a, b))
        if e is None:
            if len(self.edges) >= MAX_EDGES:
                return
            e = {"count": 0, "stack": stack}
            self.edges[(a, b)] = e
            # first time this direction appears: an inversion exists iff
            # the reverse edge was already witnessed
            if (b, a) in self.edges:
                pair = frozenset((a, b))
                if pair not in self._inversions_seen:
                    self._inversions_seen.add(pair)
                    if pair not in self.expected_inversions:
                        self._finding(
                            kind="inversion", locks=sorted(pair), stack=stack
                        )
        e["count"] = int(e["count"]) + 1  # type: ignore[call-overload]

    def _finding(self, **payload: object) -> None:
        if len(self.findings) < MAX_FINDINGS:
            self.findings.append(payload)

    # ---- reporting ----

    def inversions(self) -> List[FrozenSet[str]]:
        with self._meta:
            return sorted(self._inversions_seen, key=sorted)

    def report(self) -> Dict[str, object]:
        """JSON-ready snapshot: edges, findings, witnessed inversions."""
        with self._meta:
            return {
                "edges": [
                    {"src": a, "dst": b, "count": e["count"], "stack": e["stack"]}
                    for (a, b), e in sorted(self.edges.items())
                ],
                "findings": list(self.findings),
                "inversions": [sorted(p) for p in sorted(self._inversions_seen, key=sorted)],
                "expected_inversions": [
                    sorted(p) for p in sorted(self.expected_inversions, key=sorted)
                ],
            }

    def expect_inversion(self, a: str, b: str) -> None:
        with self._meta:
            self.expected_inversions.add(frozenset((a, b)))

    def reset(self) -> None:
        with self._meta:
            self.edges.clear()
            self.findings.clear()
            self.expected_inversions.clear()
            self._inversions_seen.clear()
            self._guards_seen.clear()
            self._holds_seen.clear()


_witness = LockWitness()


def witness() -> LockWitness:
    """The process-wide witness graph (one per process, like metrics())."""
    return _witness


def reset_witness() -> None:
    _witness.reset()


# ---- sanitized lock classes ----


class SanLock:
    """Witnessed ``threading.Lock``.

    Implements ``_is_owned`` (from the witness's per-thread bookkeeping)
    so ``threading.Condition`` accepts it without probing ``acquire(False)``
    — and deliberately does *not* implement ``_release_save``/
    ``_acquire_restore``, so ``Condition.wait`` releases and re-acquires
    through our hooks and the wait shows up in the witness naturally.
    """

    def __init__(self, name: str = "") -> None:
        self._raw = threading.Lock()
        self.name = name or f"anon-lock-{id(self):x}"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            _witness.on_acquire(self.name)
        return ok

    def release(self) -> None:
        _witness.on_release(self.name)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def held_by_current(self) -> bool:
        return _witness.held_by_current(self.name)

    # threading.Condition protocol
    def _is_owned(self) -> bool:
        return _witness.held_by_current(self.name)

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<SanLock {self.name!r} locked={self._raw.locked()}>"


class SanRLock:
    """Witnessed ``threading.RLock``: reentrant re-acquires add no edges."""

    def __init__(self, name: str = "") -> None:
        self._raw = threading.RLock()
        self.name = name or f"anon-rlock-{id(self):x}"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            _witness.on_acquire(self.name)
        return ok

    def release(self) -> None:
        _witness.on_release(self.name)
        self._raw.release()

    def held_by_current(self) -> bool:
        return _witness.held_by_current(self.name)

    def _is_owned(self) -> bool:
        return _witness.held_by_current(self.name)

    def __enter__(self) -> "SanRLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<SanRLock {self.name!r}>"


class SanCondition:
    """Witnessed ``threading.Condition`` over a :class:`SanLock`.

    Delegates to a real ``threading.Condition`` constructed *on* the
    sanitized lock: the stdlib wait/notify machinery releases and
    re-acquires via ``SanLock.release``/``acquire``, so every wait's
    release window is visible to the witness.
    """

    def __init__(self, lock: Optional[object] = None, name: str = "") -> None:
        if lock is None:
            lock = SanLock(name or f"anon-cond-{id(self):x}")
        self._lock = lock
        self.name = getattr(lock, "name", name or "cond")
        self._cond = threading.Condition(lock)  # type: ignore[arg-type]

    def acquire(self, *args: object, **kw: object) -> bool:
        return self._cond.acquire(*args, **kw)  # type: ignore[arg-type]

    def release(self) -> None:
        self._cond.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __enter__(self) -> "SanCondition":
        self._cond.__enter__()
        return self

    def __exit__(self, *exc: object) -> None:
        self._cond.__exit__(*exc)

    def __repr__(self) -> str:
        return f"<SanCondition {self.name!r}>"


# ---- factories: the only constructors the package uses ----


def Lock(name: str = ""):
    """``threading.Lock()`` — or a witnessed :class:`SanLock` under the shim."""
    if sanitize_enabled():
        return SanLock(name)
    return threading.Lock()


def RLock(name: str = ""):
    if sanitize_enabled():
        return SanRLock(name)
    return threading.RLock()


def Condition(lock: Optional[object] = None, name: str = ""):
    if sanitize_enabled():
        return SanCondition(lock, name=name)
    if lock is None:
        return threading.Condition()
    return threading.Condition(lock)  # type: ignore[arg-type]


# ---- guarded-state registration ----

_GUARD_ATTR = "_kat_guards"
_guarded_cls_cache: Dict[type, type] = {}


class _Guard:
    """Ownership check for one registered field.

    Two modes:
    * **lock mode** (``lock`` is a SanLock/SanRLock): the mutating thread
      must hold the lock.
    * **single-writer mode** (``lock is None``): the first thread to
      mutate after registration claims ownership; any other thread's
      mutation is a finding.  This encodes the LiveCache
      discipline, where correctness rests on "only the pump thread
      writes", not on a lock.
    """

    __slots__ = ("lock", "owner", "obj_name")

    def __init__(self, lock: Optional[object], obj_name: str) -> None:
        self.lock = lock if isinstance(lock, (SanLock, SanRLock)) else None
        self.owner: Optional[threading.Thread] = None
        self.obj_name = obj_name

    def ok(self) -> bool:
        if self.lock is not None:
            return self.lock.held_by_current()
        t = threading.current_thread()
        if self.owner is None:
            self.owner = t
            return True
        return self.owner is t

    @property
    def lock_name(self) -> str:
        return self.lock.name if self.lock is not None else "<single-writer>"

    @property
    def mode(self) -> str:
        return "lock" if self.lock is not None else "single-writer"


def _flag(guard: _Guard, field: str) -> None:
    _witness.on_guard(guard.lock_name, guard.obj_name, field, guard.mode)


class _GuardedDict(dict):
    __slots__ = ("_g", "_f")

    def __init__(self, data: dict, guard: _Guard, field: str) -> None:
        super().__init__(data)
        self._g = guard
        self._f = field

    def _chk(self) -> None:
        if not self._g.ok():
            _flag(self._g, self._f)

    def __setitem__(self, k, v):
        self._chk()
        return super().__setitem__(k, v)

    def __delitem__(self, k):
        self._chk()
        return super().__delitem__(k)

    def clear(self):
        self._chk()
        return super().clear()

    def pop(self, *a):
        self._chk()
        return super().pop(*a)

    def popitem(self):
        self._chk()
        return super().popitem()

    def setdefault(self, *a):
        self._chk()
        return super().setdefault(*a)

    def update(self, *a, **kw):
        self._chk()
        return super().update(*a, **kw)


class _GuardedList(list):
    __slots__ = ("_g", "_f")

    def __init__(self, data: list, guard: _Guard, field: str) -> None:
        super().__init__(data)
        self._g = guard
        self._f = field

    def _chk(self) -> None:
        if not self._g.ok():
            _flag(self._g, self._f)

    def append(self, x):
        self._chk()
        return super().append(x)

    def extend(self, it):
        self._chk()
        return super().extend(it)

    def insert(self, i, x):
        self._chk()
        return super().insert(i, x)

    def remove(self, x):
        self._chk()
        return super().remove(x)

    def pop(self, *a):
        self._chk()
        return super().pop(*a)

    def clear(self):
        self._chk()
        return super().clear()

    def sort(self, **kw):
        self._chk()
        return super().sort(**kw)

    def reverse(self):
        self._chk()
        return super().reverse()

    def __setitem__(self, i, v):
        self._chk()
        return super().__setitem__(i, v)

    def __delitem__(self, i):
        self._chk()
        return super().__delitem__(i)

    def __iadd__(self, it):
        self._chk()
        return super().__iadd__(it)


class _GuardedSet(set):
    # set has no __slots__-compatible layout with instance attrs on some
    # builds; plain attributes are fine here
    def __init__(self, data: set, guard: _Guard, field: str) -> None:
        super().__init__(data)
        self._g = guard
        self._f = field

    def _chk(self) -> None:
        if not self._g.ok():
            _flag(self._g, self._f)

    def add(self, x):
        self._chk()
        return super().add(x)

    def discard(self, x):
        self._chk()
        return super().discard(x)

    def remove(self, x):
        self._chk()
        return super().remove(x)

    def pop(self):
        self._chk()
        return super().pop()

    def clear(self):
        self._chk()
        return super().clear()

    def update(self, *a):
        self._chk()
        return super().update(*a)

    def difference_update(self, *a):
        self._chk()
        return super().difference_update(*a)

    def __ior__(self, other):
        self._chk()
        return super().__ior__(other)

    def __isub__(self, other):
        self._chk()
        return super().__isub__(other)


def _wrap_container(value: object, guard: _Guard, field: str) -> object:
    """Wrap plain containers so in-place mutation is checked, not just
    attribute rebinds.  Exact-type check: subclasses (including already-
    guarded containers) pass through untouched."""
    if type(value) is dict:
        return _GuardedDict(value, guard, field)
    if type(value) is list:
        return _GuardedList(value, guard, field)
    if type(value) is set:
        return _GuardedSet(value, guard, field)
    return value


def _guarded_class(cls: type) -> type:
    if getattr(cls, "_kat_guarded_cls", False):
        return cls
    sub = _guarded_cls_cache.get(cls)
    if sub is None:

        def __setattr__(self, attr, value):
            d = object.__getattribute__(self, "__dict__")
            guards = d.get(_GUARD_ATTR)
            if guards is not None:
                g = guards.get(attr)
                if g is not None:
                    if not g.ok():
                        _flag(g, attr)
                    # a rebind replaces the guarded container: re-wrap so
                    # coverage survives patterns like `self._queue = []`
                    value = _wrap_container(value, g, attr)
            object.__setattr__(self, attr, value)

        sub = type(
            f"Guarded{cls.__name__}",
            (cls,),
            {"__setattr__": __setattr__, "_kat_guarded_cls": True},
        )
        _guarded_cls_cache[cls] = sub
    return sub


def register_guarded(
    lock: Optional[object], obj: object, fields: Sequence[str], name: str = ""
) -> object:
    """Register (lock, fields) pairs on ``obj`` for mutation checking.

    No-op (and zero residue) when the sanitizer is off.  When on, the
    object's class is swapped for a cached subclass whose ``__setattr__``
    verifies ownership for registered fields, and current dict/list/set
    field values are wrapped in mutation-checking proxies.  ``lock=None``
    selects single-writer mode (see :class:`_Guard`).  May be called
    more than once on the same object to register fields under different
    locks (e.g. one field guarded by a container's lock while another
    is guarded by its own).
    """
    if not sanitize_enabled():
        return obj
    obj_name = name or type(obj).__name__
    guards = getattr(obj, _GUARD_ATTR, None)
    if guards is None:
        guards = {}
        object.__setattr__(obj, _GUARD_ATTR, guards)
        try:
            obj.__class__ = _guarded_class(type(obj))
        except TypeError:
            # __slots__ / extension types can't be re-classed; container
            # wrapping below still covers their mutable fields
            pass
    for f in fields:
        g = _Guard(lock, obj_name)
        guards[f] = g
        cur = getattr(obj, f, None)
        wrapped = _wrap_container(cur, g, f)
        if wrapped is not cur:
            object.__setattr__(obj, f, wrapped)
    return obj
