"""Leader election: active/passive HA for the scheduler loop (the port's
copy of kube_arbitrator_tpu/framework/leader.py; the lease record is the
same JSON, so the two packages' electors on one lock exclude each other).

Reference ``cmd/kube-batch/app/server.go:102-125``: optional leader election
over a ConfigMap resourcelock (15 s lease, 10 s renew deadline, 5 s retry);
only the leader runs ``sched.Run``; losing the lease is fatal.

Two lock backends share one election state machine (`_ElectorBase`):

* :class:`LeaderElector` — a filesystem lease (the deployment analog of the
  ConfigMap: any path on storage all replicas mount).  Writes are atomic
  (temp file + rename) and serialized with an ``fcntl`` lock so two
  contenders on one host cannot both win a race for a stale lease.
* :class:`ApiLeaderElector` — the reference's in-cluster shape: the
  LeaderElectionRecord lives in a ConfigMap annotation and contenders race
  through resourceVersion-preconditioned updates (client-go resourcelock
  CAS semantics), so schedulers on DIFFERENT hosts contend through one
  apiserver — ``api`` is anything speaking the FakeApiServer verbs, the
  in-process store or :class:`cache.httpapi.HttpApiClient`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import os
import time
import uuid

from ..cache.fakeapi import ApiError
from ..utils.metrics import metrics
from typing import Callable, Optional


class LeaderLost(RuntimeError):
    """Raised when the lease cannot be renewed; fatal like the reference's
    OnStoppedLeading → Fatalf (server.go:119-121)."""


@dataclasses.dataclass
class LeaseRecord:
    holder: str
    acquired_ts: float
    renew_ts: float
    lease_duration_s: float

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "LeaseRecord":
        return cls(**json.loads(s))


class TransientLockError(RuntimeError):
    """Storage hiccup (apiserver unreachable / 5xx): the lease state is
    UNKNOWN, as opposed to definitively lost."""


class _ElectorBase:
    """The client-go leaderelection state machine over abstract storage.

    Subclasses provide ``_fetch() -> (token, LeaseRecord|None)`` (raising
    :class:`TransientLockError` when the store cannot be read),
    ``_push(token, rec) -> bool`` (False on a lost write race) and
    ``_delete(token)``; ``_locked()`` may serialize the read-modify-write
    for backends without compare-and-swap.

    Two client-go behaviors matter for multi-host correctness:

    * **Observer-local lease timing.**  A contender never compares its own
      clock against the holder's embedded ``renew_ts`` (cross-host clock
      skew would let a skewed standby steal a live lease and run two
      leaders).  Instead it remembers WHEN IT FIRST OBSERVED the current
      record on its own clock and only treats the lease as expired once a
      full ``lease_duration_s`` passes without the record changing
      (client-go's observedRecord/observedTime).
    * **Renew-deadline grace.**  A transient storage error during renewal
      keeps leadership until ``renew_deadline_s`` elapses since the last
      SUCCESSFUL renewal; only then is the lease reported lost."""

    identity: str
    lease_duration_s: float
    renew_deadline_s: float
    retry_period_s: float
    now: Callable[[], float]
    # injectable sleep for acquire_blocking's retry loop: tests
    # substitute a virtual clock's sleep so standby contention
    # consumes simulated, not wall, time
    sleep: Callable[[float], None] = staticmethod(time.sleep)
    _is_leader: bool = False
    _observed_key = None      # (holder, renew_ts) of the last seen record
    _observed_at: float = 0.0  # our clock when that record FIRST appeared
    _last_renew_ok: float = 0.0

    @staticmethod
    def _validate_timing(lease_duration_s, renew_deadline_s, retry_period_s):
        """client-go's NewLeaderElector ordering checks: the renew-blip
        grace (renew() keeps leadership on a failed fetch/CAS while
        now - _last_renew_ok <= renew_deadline_s) is only dual-leader-safe
        because a standby needs a full unchanged lease_duration_s before
        usurping — a renew_deadline >= lease_duration would let a wedged
        leader believe itself live after a standby legally took over."""
        if lease_duration_s <= renew_deadline_s:
            raise ValueError(
                f"lease_duration_s ({lease_duration_s}) must be greater than "
                f"renew_deadline_s ({renew_deadline_s})"
            )
        if renew_deadline_s <= retry_period_s:
            raise ValueError(
                f"renew_deadline_s ({renew_deadline_s}) must be greater than "
                f"retry_period_s ({retry_period_s})"
            )
        if retry_period_s <= 0:
            raise ValueError(f"retry_period_s ({retry_period_s}) must be positive")

    def _locked(self):
        return contextlib.nullcontext()

    def _observe(self, cur: Optional[LeaseRecord], now: float) -> None:
        key = (cur.holder, cur.renew_ts) if cur is not None else None
        if key != self._observed_key:
            self._observed_key = key
            self._observed_at = now

    # ---- election decisions (shared) ----

    def _note_transition(self, was_leader: bool) -> None:
        """Leadership telemetry: the is-leader gauge plus a transitions
        counter on every flip (the reference logs these; SURVEY §5 wants
        them scrapeable — a flapping lease is invisible in averages)."""
        m = metrics()
        m.gauge_set("leader_is_leader", 1.0 if self._is_leader else 0.0)
        if self._is_leader != was_leader:
            m.counter_add(
                "leader_transitions_total",
                labels={"to": "leader" if self._is_leader else "standby"},
            )

    def try_acquire(self) -> bool:
        """One acquisition attempt: take the lease if unheld, expired (on
        OUR observation clock), or already ours.  Returns leadership."""
        was = self._is_leader
        try:
            return self._try_acquire_inner()
        finally:
            self._note_transition(was)

    def _try_acquire_inner(self) -> bool:
        with self._locked():
            try:
                token, cur = self._fetch()
            except TransientLockError:
                self._is_leader = False
                return False  # can't read the lock: keep retrying
            now = self.now()
            self._observe(cur, now)
            if cur is not None and cur.holder != self.identity:
                if now - self._observed_at < cur.lease_duration_s:
                    self._is_leader = False
                    return False  # held by a live (recently-observed) leader
            acquired = cur.acquired_ts if cur and cur.holder == self.identity else now
            rec = LeaseRecord(
                holder=self.identity,
                acquired_ts=acquired,
                renew_ts=now,
                lease_duration_s=self.lease_duration_s,
            )
            self._is_leader = self._push(token, rec)
            if self._is_leader:
                self._last_renew_ok = now
            return self._is_leader

    def _within_renew_deadline(self, now: float) -> bool:
        """THE freshness window — one definition for renew()'s blip
        grace, the renew-deadline loss check, and lease_fresh()'s
        actuation fence, so the boundary can never drift between them."""
        return now - self._last_renew_ok <= self.renew_deadline_s

    def renew(self) -> bool:
        """Renew our lease; False when another holder took it (we were
        expired and usurped) or the renew deadline passed.  A transient
        storage error keeps leadership within the renew deadline."""
        was = self._is_leader
        t0 = time.perf_counter()
        try:
            return self._renew_inner()
        finally:
            metrics().observe(
                "leader_renew_duration_seconds", time.perf_counter() - t0
            )
            self._note_transition(was)

    def _renew_inner(self) -> bool:
        with self._locked():
            try:
                token, cur = self._fetch()
            except TransientLockError:
                # deadline must use the clock AFTER the fetch: a hung
                # apiserver call (client timeout ~ renew deadline) must
                # not extend leadership past the deadline while a standby
                # legitimately steals the stale lease (dual-leader hole)
                now = self.now()
                if self._is_leader and self._within_renew_deadline(now):
                    return True  # storage blip; retry next period
                self._is_leader = False
                return False
            now = self.now()
            self._observe(cur, now)
            if cur is None or cur.holder != self.identity:
                self._is_leader = False
                return False
            if not self._within_renew_deadline(now):
                # we failed to renew in time; treat as lost even if nobody
                # has usurped yet (client-go renew-deadline semantics)
                self._is_leader = False
                return False
            pushed = self._push(token, dataclasses.replace(cur, renew_ts=now))
            if pushed:
                self._last_renew_ok = now
                self._is_leader = True
            elif self._within_renew_deadline(now):
                return self._is_leader  # write blip/race; retry next period
            else:
                self._is_leader = False
            return self._is_leader

    def release(self) -> None:
        """Voluntary release (delete the lock object) so a standby can take
        over immediately instead of waiting out the lease."""
        was = self._is_leader
        try:
            self._release_inner()
        finally:
            self._note_transition(was)

    def _release_inner(self) -> None:
        with self._locked():
            try:
                token, cur = self._fetch()
            except TransientLockError:
                self._is_leader = False  # best-effort: lease will expire
                return
            if cur is not None and cur.holder == self.identity:
                self._delete(token)
            self._is_leader = False

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    def lease_fresh(self) -> bool:
        """RPC-free staleness check: True while the last successful renew
        is within ``renew_deadline_s``.  The scheduler gates ACTUATION on
        this — a decision program that hangs past the deadline (wedged
        accelerator tunnel) must not apply its stale binds/evicts after a
        standby has legitimately taken the lease.  Same clock and window
        as renew()'s blip grace, so a fresh lease can always actuate.
        A failed check DEMOTES: the caller is about to abandon the cycle,
        and a supervisor's re-contention loop must see is_leader False so
        it re-acquires instead of instantly re-raising."""
        if self._is_leader and self._within_renew_deadline(self.now()):
            return True
        was = self._is_leader
        self._is_leader = False
        # the actuation-fence demotion must be scrapeable too: without
        # this, a wedged-decide LeaderLost leaves leader_is_leader at 1
        self._note_transition(was)
        return False

    def revalidate(self) -> bool:
        """Storage-backed re-check for the actuation fence: re-read the
        lock and push a fresh renew_ts iff the record STILL names us.

        ``lease_fresh()`` is clock-only — a slow-but-healthy cycle that
        lands in the (renew_deadline, lease_duration] window looks stale
        to it even though no standby can have legally usurped yet (a
        usurper needs a full unchanged lease_duration).  This consults
        the source of truth instead: if the lease record is still ours
        and the CAS write succeeds, leadership (and ``_last_renew_ok``)
        is restored and the cycle may actuate; if another holder took
        the lease — or storage can't confirm — the caller must discard
        the cycle.  Unlike :meth:`renew` this deliberately ignores the
        renew deadline: the deadline bounds how long a leader may coast
        on BLIND grace, not how late a successful storage round-trip may
        confirm leadership."""
        was = self._is_leader
        try:
            return self._revalidate_inner()
        finally:
            self._note_transition(was)

    def _revalidate_inner(self) -> bool:
        with self._locked():
            try:
                token, cur = self._fetch()
            except TransientLockError:
                self._is_leader = False
                return False  # cannot confirm against storage: stay demoted
            now = self.now()
            self._observe(cur, now)
            if cur is None or cur.holder != self.identity:
                self._is_leader = False
                return False
            if self._push(token, dataclasses.replace(cur, renew_ts=now)):
                self._last_renew_ok = now
                self._is_leader = True
            else:
                self._is_leader = False
            return self._is_leader

    def acquire_blocking(self, timeout_s: Optional[float] = None) -> bool:
        """RunOrDie's acquisition loop: retry every retry_period until
        leadership (or timeout, for tests/CLI)."""
        start = self.now()
        while True:
            if self.try_acquire():
                return True
            if timeout_s is not None and self.now() - start >= timeout_s:
                return False
            self.sleep(self.retry_period_s)


class LeaderElector(_ElectorBase):
    """File-lease leader election with the client-go leaderelection
    parameters (lease duration / renew deadline / retry period)."""

    def __init__(
        self,
        lock_path: str,
        identity: str = "",
        lease_duration_s: float = 15.0,
        renew_deadline_s: float = 10.0,
        retry_period_s: float = 5.0,
        now_fn: Callable[[], float] = time.time,
    ):
        self._validate_timing(lease_duration_s, renew_deadline_s, retry_period_s)
        self.lock_path = lock_path
        self.identity = identity or f"{os.uname().nodename}-{uuid.uuid4().hex[:8]}"
        self.lease_duration_s = lease_duration_s
        self.renew_deadline_s = renew_deadline_s
        self.retry_period_s = retry_period_s
        self.now = now_fn
        self._is_leader = False
        os.makedirs(os.path.dirname(os.path.abspath(lock_path)), exist_ok=True)

    # ---- storage hooks ----

    @contextlib.contextmanager
    def _locked(self):
        # the file backend has no CAS; flock serializes read-modify-write
        with open(self.lock_path + ".mutex", "w") as mf:
            fcntl.flock(mf, fcntl.LOCK_EX)
            yield

    def _fetch(self):
        try:
            with open(self.lock_path) as f:
                return None, LeaseRecord.from_json(f.read())
        except (FileNotFoundError, ValueError, TypeError, KeyError):
            return None, None

    def _push(self, token, rec: LeaseRecord) -> bool:
        tmp = f"{self.lock_path}.{self.identity}.tmp"
        with open(tmp, "w") as f:
            f.write(rec.to_json())
        os.rename(tmp, self.lock_path)
        return True  # the flock in _locked() already excluded racers

    def _delete(self, token) -> None:
        os.unlink(self.lock_path)


LOCK_CONFIGMAP = "kube-batch-lock"  # reference default lock object name
LEASE_ANNOTATION = "control-plane.alpha.kubernetes.io/leader"


class ApiLeaderElector(_ElectorBase):
    """Leader election over an apiserver ConfigMap resourcelock
    (``server.go:102-125`` via client-go's ConfigMapsResourceLock).

    Storage races resolve through resourceVersion CAS instead of a host
    mutex; transient apiserver failures (unreachable / 5xx) surface as a
    lost attempt (False), never an exception — contenders keep retrying on
    their retry period, matching client-go's tolerance of apiserver
    blips.  Release is a compare-and-delete on the fetched rv so a stale
    ex-leader cannot remove a lease a standby has since re-acquired."""

    def __init__(
        self,
        api,
        namespace: str = "kube-system",
        name: str = LOCK_CONFIGMAP,
        identity: str = "",
        lease_duration_s: float = 15.0,
        renew_deadline_s: float = 10.0,
        retry_period_s: float = 5.0,
        now_fn: Callable[[], float] = time.time,
    ):
        self._validate_timing(lease_duration_s, renew_deadline_s, retry_period_s)
        self.api = api
        self.namespace = namespace
        self.name = name
        self.identity = identity or f"{os.uname().nodename}-{uuid.uuid4().hex[:8]}"
        self.lease_duration_s = lease_duration_s
        self.renew_deadline_s = renew_deadline_s
        self.retry_period_s = retry_period_s
        self.now = now_fn
        self._is_leader = False

    # ---- storage hooks ----

    def _fetch(self):
        try:
            obj = self.api.get("configmaps", self.namespace, self.name)
        except ApiError as err:
            # unreadable lock (unreachable/5xx): state is UNKNOWN — the
            # base machine keeps leadership within the renew deadline and
            # keeps standbys retrying, like client-go on apiserver blips
            raise TransientLockError(str(err)) from err
        if obj is None:
            return None, None
        raw = obj.get("metadata", {}).get("annotations", {}).get(LEASE_ANNOTATION)
        if not raw:
            return obj, None
        try:
            return obj, LeaseRecord.from_json(raw)
        except (ValueError, TypeError, KeyError):
            return obj, None

    def _push(self, obj, rec: LeaseRecord) -> bool:
        try:
            if obj is None:
                self.api.create(
                    "configmaps",
                    {
                        "metadata": {
                            "namespace": self.namespace,
                            "name": self.name,
                            "annotations": {LEASE_ANNOTATION: rec.to_json()},
                        }
                    },
                )
            else:
                rv = obj.get("metadata", {}).get("resourceVersion")
                obj.setdefault("metadata", {}).setdefault("annotations", {})[
                    LEASE_ANNOTATION
                ] = rec.to_json()
                self.api.update("configmaps", obj, expect_rv=rv)
            return True
        except ApiError:
            return False  # lost the race (409) or the apiserver blipped

    def _delete(self, obj) -> None:
        try:
            rv = (obj or {}).get("metadata", {}).get("resourceVersion")
            self.api.delete("configmaps", self.namespace, self.name, expect_rv=rv)
        except ApiError:
            pass  # already gone or re-acquired by a standby — both fine


def usurp_lease(
    api,
    holder: str,
    now: float,
    namespace: str = "kube-system",
    name: str = LOCK_CONFIGMAP,
    lease_duration_s: float = 15.0,
) -> LeaseRecord:
    """TEST SEAM — overwrite the ConfigMap resourcelock with a record
    naming ``holder``, emulating a standby that legally acquired after the
    leader's lease expired on ITS observation clock.  The wedged ex-leader
    must then be stopped by the actuation fence (``lease_fresh`` +
    ``revalidate``): the record no longer names it, so ``revalidate``
    fails and the cycle's binds/evicts are discarded — the single-actuator
    invariant.  Never called outside tests and chip_smoke.py."""
    rec = LeaseRecord(
        holder=holder, acquired_ts=now, renew_ts=now,
        lease_duration_s=lease_duration_s,
    )
    obj = api.get("configmaps", namespace, name)
    if obj is None:
        api.create(
            "configmaps",
            {
                "metadata": {
                    "namespace": namespace,
                    "name": name,
                    "annotations": {LEASE_ANNOTATION: rec.to_json()},
                }
            },
        )
    else:
        obj.setdefault("metadata", {}).setdefault("annotations", {})[
            LEASE_ANNOTATION
        ] = rec.to_json()
        api.update(
            "configmaps", obj,
            expect_rv=obj.get("metadata", {}).get("resourceVersion"),
        )
    return rec
