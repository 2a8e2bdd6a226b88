"""Multi-replica decision pool: batched fleet serving for many tenants
(the port of kube_arbitrator_tpu/rpc/pool.py).

The fleet shape multiplexes **M tenant scheduler frontends** — each
owning its own cluster state, leader lease and actuation — onto **N
shared decision replicas**.  Three mechanisms make the pool more than a
load balancer:

* **Request batching** — a bounded-delay batcher groups *shape-compatible*
  snapshot packs (:func:`pack_shape_key`: the same symbolic axes
  T/N/G/J/Q/..., the same static fields, the same conf and the same
  evictive class) and serves each group with ONE batched launch, B15
  (ops/cycle.batched_schedule_cycle): the tenants' cycles run in
  lockstep on one stream, each with its own plans and its own K1-K20
  launches, and every step of all of them is served by one host read.
  Each tenant's decisions are its own single cycle's, bit for bit; the
  per-tenant corr ids ride each request and land in the decision log.
* **Epoch-keyed replication** — every tenant's delta stream
  (cache/arena.PackMeta) is fanned out to every reachable replica, each
  holding a per-tenant pack resident on the device
  (framework/decider.ResidentPack: K18 writes a delta's changed rows).
  Any replica can serve any tenant's next cycle; a replica that lost a
  base (restart, healed partition) is re-seeded from the full pack in
  hand.
* **Routing, backpressure and load shedding** — least-loaded routing
  (inflight count, round-robin tiebreak) over alive, non-partitioned
  replicas; per-tenant admission on the SLO burn monitor
  (utils/timeseries.SloBurnMonitor) over each tenant's served latencies:
  a tenant burning its error budget in BOTH windows is shed
  (``PoolShed``, a retryable cycle error) until its burn recovers.

Departures from the reference: the batch is not padded to a power-of-two
bucket (the reference pads so that XLA compiles one program a bucket;
nothing here compiles per batch size), so the batch metrics report
occupancy 1.0 and padding 0; every replica of a process serves on the one
device the pool was given, and one batch at a time runs on it
(``_LAUNCH_LOCK``: the tenants' launches share one stream, and K16's
plans and count words are shared by the process); the conf enters the
shape key as a fingerprint of ``from_config(config)``, not of its YAML
dump (PyYAML is optional); the tracing spans of a request and a batch
and the fleet plane (``fleet=``) are not ported.

Thread discipline: every lock of the pool guards only dict / deque / int
operations; uploads and launches run outside them (a launch inside
``_LAUNCH_LOCK`` only).  In threaded mode there is at most ONE in-flight
request per tenant, so a tenant's delta chain is sequential.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api.types import TaskStatus
from ..device import DeviceLike, resolve_device
from ..framework.conf import from_config
from ..framework.decider import ResidentPack, _field
from ..ops.cycle import batched_schedule_cycle, decisions_to_host
from ..utils import locking
from ..utils.metrics import MetricsRegistry, metrics

# pool admission: one (long, short, threshold) burn-window pair scaled to
# a ~1 s cycle cadence — the long window proves the overload is
# sustained, the short window proves it is still happening
POOL_BURN_WINDOWS: Tuple[Tuple[float, float, float], ...] = ((60.0, 10.0, 2.0),)

# one batch on the card at a time in this process: a batch's launches go
# to one stream, and K16's plans (ops/kernels/stable_compact.py) and
# count words are shared by every caller of the device
_LAUNCH_LOCK = threading.Lock()


def _pad_bucket(n: int) -> int:
    """The reference's bucket of a batch of ``n`` (the next power of two,
    which it pads to): the port's batch metrics keep it as their label,
    and read nothing else of it; the port launches ``n`` cycles."""
    b = 1
    while b < n:
        b *= 2
    return b


class PoolShed(RuntimeError):
    """Admission dropped the request: the tenant has been burning its
    latency error budget in both burn windows (sustained AND still
    happening).  Retryable — the tenant's loop counts a retryable cycle
    error and tries again next cycle."""

    retryable = True


class PoolUnavailable(RuntimeError):
    """No alive, non-partitioned replica could serve the request this
    cycle.  Retryable — replicas restart hitlessly and partitions heal."""

    retryable = True


class _ReplicaLost(RuntimeError):
    """Internal reroute signal: the routed replica died mid-decide (the
    fault-hook seam); the pool retries the group on another replica."""

    def __init__(self, replica_index: int):
        super().__init__(f"replica r{replica_index} lost mid-decide")
        self.replica_index = replica_index


def _snapshot_axes(t) -> Dict[str, int]:
    """The symbolic axes of a built pack (the reference's
    analysis/contracts._snapshot_axes): every field's shape is a
    function of these, so equal axes are equal shapes for the pack."""
    def dim(name, i):
        return int(np.shape(_field(t, name))[i])

    return {
        "T": dim("task_resreq", 0), "N": dim("node_idle", 0), "G": dim("group_job", 0),
        "J": dim("job_queue", 0), "Q": dim("queue_weight", 0), "R": dim("task_resreq", 1),
        "W": dim("task_ports", 1), "CT": dim("class_fit", 0), "CN": dim("class_fit", 1),
        "K": dim("node_dom", 0), "TF": dim("aff_key", 0), "TA": dim("anti_key", 0),
        "D": dim("aff_static", 1), "CP": dim("aff_match", 1), "CS": dim("symm_ok", 0),
        "MA": dim("group_aff_terms", 1), "MB": dim("group_anti_terms", 1),
        "V": dim("rv_idx", 0),
    }


def is_evictive(actions, task_status) -> bool:
    """The reference's evictive-cycle classifier (platform.is_evictive):
    reclaim / preempt in the action list AND running victims present."""
    return bool(set(actions) & {"reclaim", "reclaim_optimistic", "preempt"}) and bool(
        (np.asarray(task_status) == int(TaskStatus.RUNNING)).any())


def conf_fingerprint(config) -> str:
    """A conf's fingerprint: the digest of ``from_config(config)``'s
    repr (actions, tiers, every plugin's flags and arguments)."""
    return hashlib.sha256(repr(from_config(config)).encode()).hexdigest()[:8]


def pack_shape_key(st, conf_fp: str = "", actions=(), decode_caps=None) -> str:
    """The batching-compatibility key: the pack's symbolic axes, its
    static fields, the conf's fingerprint (:func:`conf_fingerprint`), the
    evictive class and the tenant's decode caps.  Packs group exactly as
    the reference's key groups them (its key strings differ: the
    reference digests the conf's YAML)."""
    st = getattr(st, "tensors", st)
    axes = _snapshot_axes(st)
    statics = (("rv_window", int(_field(st, "rv_window", 0))),)
    ax = "/".join(f"{k}{v}" for k, v in sorted(axes.items()))
    ev = int(is_evictive(tuple(actions), _field(st, "task_status")))
    caps = "" if decode_caps is None else f"|caps{tuple(decode_caps)}"
    return f"{ax}|{statics}|ev{ev}|conf:{conf_fp}{caps}"


@dataclasses.dataclass
class PoolRequest:
    """One tenant cycle's decide request traveling through the pool."""

    tenant: str
    st: object                    # full host pack
    config: object
    conf_fp: str
    pack_meta: object             # cache/arena.PackMeta or None
    corr: Optional[str]
    seq: int                      # per-tenant request sequence
    shape: str                    # pack_shape_key
    t_submit: float
    # resolved by the serving path:
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    decisions: object = None
    kernel_ms: float = 0.0
    error: Optional[BaseException] = None
    replica: Optional[str] = None
    batch: int = 0
    batch_id: Optional[str] = None  # the shared launch's join id
    reseeded: bool = False
    # the serving replica's upload of this epoch: "full" / "delta" / "reuse", bytes
    upload_mode: str = ""
    upload_bytes: int = 0
    # set by a timed-out decide(): a late completion must not record
    # the wait as a served latency
    abandoned: bool = False


class PoolReplica:
    """One decision replica on ``device``: per-tenant epoch-keyed packs
    resident on the device (:class:`ResidentPack`) plus the batched
    launch entry (``decide_batch`` — tests override it to fault the
    serve path).  ``restart()`` models a replica crash / redeploy: its
    resident packs are gone, and every tenant's next decide re-seeds it
    from the full pack in hand."""

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.id = f"r{index}"
        self.device = device
        self._lock = locking.Lock("pool.replica.lock")
        self._packs: Dict[str, ResidentPack] = {}
        self.inflight = 0
        self.restarts = 0
        self.cycles_served = 0

    def apply_delta(self, tenant: str, st, meta) -> str:
        """Fan-out replication: write the delta ``meta`` describes into
        this replica's resident pack for ``tenant`` (K18), or (re-)seed it
        whole when its base epoch is not resident.  Returns ``"delta"`` or
        ``"full"``, as the reference classifies the epoch."""
        base = meta.base_key if meta is not None else None
        with self._lock:
            pack = self._packs.get(tenant)
            if pack is None:
                pack = self._packs[tenant] = ResidentPack()
        full = meta is None or base is None or pack.key != base
        pack.upload(st, meta, self.device)
        return "full" if full else "delta"

    def resident(self, tenant: str) -> Tuple[Optional[str], object]:
        """(epoch key, resident SnapshotTensors) of ``tenant``."""
        with self._lock:
            pack = self._packs.get(tenant)
        if pack is None or pack.pack is None:
            raise KeyError(f"replica {self.id} holds no pack for {tenant}")
        return pack.key, pack.pack

    def upload_of(self, tenant: str) -> Tuple[str, int]:
        """(mode, bytes) of the last upload into ``tenant``'s pack."""
        with self._lock:
            pack = self._packs.get(tenant)
        if pack is None:
            return "none", 0
        return pack.resident.last_mode, pack.resident.last_upload_bytes

    def resident_tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._packs)

    def restart(self) -> None:
        with self._lock:
            self._packs.clear()
            self.restarts += 1

    def decide_batch(self, packs: Tuple, config, decode_caps=None) -> Tuple[Tuple, float]:
        """Serve every pack of one shape-compatible group with one batched
        launch (:func:`_run_batched`); returns (host decisions a pack,
        the launch's synchronised wall ms)."""
        conf = from_config(config)
        with _LAUNCH_LOCK:
            t0 = time.perf_counter()
            decs = _run_batched(packs, conf.tiers, conf.actions,
                                None if decode_caps is None else tuple(decode_caps))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            ms = (time.perf_counter() - t0) * 1000
            out = tuple(decisions_to_host(d) for d in decs)
        with self._lock:
            self.cycles_served += len(packs)
        return out, ms


def _run_batched(packs, tiers, actions, decode_caps=None):
    """B15: the group's cycles in one batched launch
    (ops/cycle.batched_schedule_cycle: lockstep on one stream, one host
    read a step for all of them).  Each tenant's decisions equal its own
    ``schedule_cycle``'s, field for field; ``decode_caps`` is the
    group's, uniform since the caps are part of the shape key."""
    return batched_schedule_cycle(packs, tiers=tiers, actions=actions, decode_caps=decode_caps)


class TenantAdmission:
    """Per-tenant load shedding on the SLO burn monitor: each tenant's
    served latencies land in a :class:`TimeSeriesRing`, and a
    :class:`SloBurnMonitor` computes the burn.  ``should_shed`` is True
    while both the long and short windows of any pair burn at or past
    their threshold, with a ``min_samples`` guard so a cold tenant cannot
    be shed by its first slow cycle."""

    def __init__(
        self,
        slo_ms: float,
        budget: float = 0.05,
        windows: Tuple[Tuple[float, float, float], ...] = POOL_BURN_WINDOWS,
        min_samples: int = 8,
        now_fn: Optional[Callable[[], float]] = None,
    ):
        self.slo_ms = float(slo_ms)
        self.budget = float(budget)
        self.windows = tuple(windows)
        self.min_samples = min_samples
        self.now = now_fn or time.time
        self._lock = locking.Lock("pool.admission.lock")
        self._rings: Dict[str, object] = {}
        self._monitors: Dict[str, object] = {}

    def _monitor(self, tenant: str):
        from ..utils.timeseries import SloBurnMonitor, TimeSeriesRing

        with self._lock:
            mon = self._monitors.get(tenant)
        if mon is None:
            ring = TimeSeriesRing(capacity=512, now_fn=self.now)
            mon = SloBurnMonitor(
                ring, slo_ms=self.slo_ms, budget=self.budget,
                windows=self.windows, min_samples=self.min_samples,
            )
            with self._lock:
                self._rings[tenant] = ring
                self._monitors[tenant] = mon
        return mon

    def observe(self, tenant: str, latency_ms: float) -> None:
        self._monitor(tenant)
        with self._lock:
            ring = self._rings[tenant]
        ring.sample({"cycle_ms": float(latency_ms)})

    def burn(self, tenant: str) -> Optional[float]:
        mon = self._monitor(tenant)
        return mon.burn_rate(self.windows[0][0], now=self.now())

    def should_shed(self, tenant: str) -> bool:
        mon = self._monitor(tenant)
        with self._lock:
            ring = self._rings[tenant]
        now = self.now()
        for long_s, short_s, threshold in self.windows:
            if len(ring.rows(long_s, now)) < self.min_samples:
                continue
            long_burn = mon.burn_rate(long_s, now)
            short_burn = mon.burn_rate(short_s, now)
            if (
                long_burn is not None and long_burn >= threshold
                and short_burn is not None and short_burn >= threshold
            ):
                return True
        return False


class DecisionPool:
    """N decision replicas serving M tenant frontends on ``device`` (the
    card unless the caller passes ``"cpu"``; without CUDA and without
    ``"cpu"`` the constructor raises); see the module docstring.
    ``threaded=True`` starts the bounded-delay batcher (a dispatcher
    thread and one worker per replica); ``threaded=False`` serves each
    request inline on the calling thread (a batch of whatever
    ``decide_many`` hands it)."""

    def __init__(
        self,
        replicas: int = 2,
        max_batch: int = 8,
        batch_delay_s: float = 0.002,
        min_fill: int = 1,
        admission: Optional[TenantAdmission] = None,
        threaded: bool = False,
        now_fn: Optional[Callable[[], float]] = None,
        registry: Optional[MetricsRegistry] = None,
        log_capacity: int = 4096,
        fault_hook=None,
        fleet=None,
        device: DeviceLike = None,
    ):
        if fleet is not None:
            raise ValueError("DecisionPool(fleet=...): the fleet plane (utils/fleet.py) "
                             "is not ported; pass fleet=None")
        self.device = resolve_device(device)
        self.replicas = [PoolReplica(i, self.device) for i in range(replicas)]
        self.max_batch = max_batch
        self.batch_delay_s = batch_delay_s
        self.min_fill = min_fill
        self.admission = admission
        self.now = now_fn or time.time
        self.registry = registry
        self.log_capacity = log_capacity
        # fault seam: called with (replica, group) at the serve entry;
        # may kill / partition / slow the pool and may raise _ReplicaLost
        self.fault_hook = fault_hook
        self.fleet = None
        self.cycle = 0
        self._lock = locking.Lock("pool.lock")
        self._seq: Dict[str, int] = {}
        # config object -> (config ref, fingerprint); see _conf_fp
        self._confs: Dict[int, Tuple[object, str]] = {}
        # (replica_index, tenant) -> heal-at pool cycle
        self._partitions: Dict[Tuple[int, str], int] = {}
        # the decision log: every serve / shed / error lands here, bounded
        self.decision_log: List[dict] = []
        self.shed_log: List[dict] = []
        # sensitivity seam: drop served entries so a checker of the log
        # MUST breach
        self.log_drop_served = False
        self._rr = 0
        # launch ordinal (the batch_id mint) and the shape keys already
        # launched once (first-use vs reuse attribution)
        self._batch_seq = 0
        self._warm_buckets: set = set()
        self._stop = False
        self._queue: List[PoolRequest] = []
        self._cond = locking.Condition(self._lock)
        self._dispatcher: Optional[threading.Thread] = None
        self._workers: Optional[List[ThreadPoolExecutor]] = None
        if locking.sanitize_enabled():
            # every field below is written only under self._lock (held
            # directly or via self._cond); NOT self.cycle — begin_cycle
            # rebinds it bare (single writer: the driving thread)
            locking.register_guarded(
                self._lock, self,
                (
                    "_seq", "_confs", "_partitions", "decision_log",
                    "shed_log", "_rr", "_batch_seq", "_warm_buckets",
                    "_stop", "_queue",
                ),
                name="DecisionPool",
            )
            for r in self.replicas:
                locking.register_guarded(
                    self._lock, r, ("inflight",), name=f"PoolReplica[{r.id}]"
                )
                locking.register_guarded(
                    r._lock, r,
                    ("_packs", "restarts", "cycles_served"),
                    name=f"PoolReplica[{r.id}]",
                )
        if threaded:
            self._workers = [
                ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=f"kat-pool-{r.id}"
                )
                for r in self.replicas
            ]
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, name="kat-pool-dispatch",
                daemon=True,
            )
            self._dispatcher.start()

    # ---- metrics ----

    def _metrics(self) -> MetricsRegistry:
        return self.registry if self.registry is not None else metrics()

    def _count(self, tenant: str, outcome: str) -> None:
        self._metrics().counter_add(
            "pool_requests_total", labels={"tenant": tenant, "outcome": outcome}
        )

    def _gauge_inflight(self, replica: PoolReplica) -> None:
        self._metrics().gauge_set(
            "pool_replica_inflight", replica.inflight,
            labels={"replica": replica.id},
        )

    # ---- lifecycle / fault surface ----

    def begin_cycle(self, cycle: int) -> None:
        """Pool-cycle bookkeeping: heals partitions whose deadline passed."""
        self.cycle = cycle
        with self._lock:
            healed = [k for k, until in self._partitions.items() if until <= cycle]
            for k in healed:
                del self._partitions[k]

    def kill_replica(self, index: int) -> None:
        """Crash / redeploy replica ``index``: its resident packs are gone;
        it rejoins at once and re-seeds per tenant on its next serve."""
        self.replicas[index].restart()

    def partition(self, index: int, tenant: str, cycles: int = 1) -> None:
        """Partition replica ``index`` from ``tenant`` for ``cycles`` pool
        cycles: no delta fan-out reaches it and routing skips it; on heal
        its stale base forces a full re-seed."""
        with self._lock:
            self._partitions[(index, tenant)] = self.cycle + max(1, cycles)

    def is_partitioned(self, index: int, tenant: str) -> bool:
        with self._lock:
            return (index, tenant) in self._partitions

    def status(self) -> dict:
        """The /debug/pool document."""
        with self._lock:
            partitions = [
                {"replica": f"r{i}", "tenant": t, "heal_at_cycle": until}
                for (i, t), until in sorted(self._partitions.items())
            ]
            queue_depth = len(self._queue)
            sheds = list(self.shed_log[-64:])
            log_tail = list(self.decision_log[-64:])
        return {
            "replicas": [
                {
                    "id": r.id,
                    "inflight": r.inflight,
                    "cycles_served": r.cycles_served,
                    "restarts": r.restarts,
                    "resident_tenants": r.resident_tenants(),
                }
                for r in self.replicas
            ],
            "partitions": partitions,
            "queue_depth": queue_depth,
            "sheds": sheds,
            "decision_log_tail": log_tail,
        }

    # ---- the decider-facing entry ----

    def decide(
        self, tenant: str, st, config, pack_meta=None, corr: Optional[str] = None
    ) -> Tuple[object, float]:
        return self.decide_request(tenant, st, config, pack_meta, corr)[:2]

    def decide_request(self, tenant: str, st, config, pack_meta=None,
                       corr: Optional[str] = None) -> Tuple[object, float, PoolRequest]:
        """:meth:`decide`, with the resolved request as a third value."""
        req = self._request(tenant, st, config, pack_meta, corr)
        if req.error is not None:  # shed at the door
            raise req.error
        if self._dispatcher is not None:
            with self._cond:
                if self._stop:
                    # nothing will ever drain the queue of a closed pool
                    raise PoolUnavailable(
                        f"tenant {req.tenant} decide on a closed pool"
                    )
                self._queue.append(req)
                self._cond.notify_all()
            if not req.event.wait(timeout=600.0):
                # abandon, atomically against the serve path's claim: pull
                # the request back out of the queue and flag an in-flight
                # one so its late completion is logged "abandoned"
                with self._cond:
                    done = req.event.is_set()
                    if not done:
                        if req in self._queue:
                            self._queue.remove(req)
                        req.abandoned = True
                if not done:
                    req.error = PoolUnavailable(
                        f"tenant {req.tenant} decide timed out in the pool queue"
                    )
        else:
            self._process([req])
        if req.error is not None:
            raise req.error
        return req.decisions, req.kernel_ms, req

    def decide_many(self, reqs: List[Tuple]) -> List[PoolRequest]:
        """Synchronous multi-request entry: builds and serves one flush of
        requests, returning the resolved PoolRequests (errors stored, not
        raised).  Each request is ``(tenant, st, config, meta)`` or
        ``(tenant, st, config, meta, corr)``."""
        built = [
            self._request(*(r if len(r) == 5 else (*r, None)))
            for r in reqs
        ]
        live = [r for r in built if r.error is None]
        if live:
            self._process(live)
        return built

    def _conf_fp(self, config) -> str:
        """The conf's fingerprint, cached per config object (tenants pass
        the same long-lived config every cycle); the cache holds the
        config reference, so an id() is not recycled while it lives."""
        key = id(config)
        with self._lock:
            hit = self._confs.get(key)
        if hit is not None and hit[0] is config:
            return hit[1]
        fp = conf_fingerprint(config)
        with self._lock:
            self._confs[key] = (config, fp)
            while len(self._confs) > 64:
                self._confs.pop(next(iter(self._confs)))
        return fp

    def _request(self, tenant, st, config, pack_meta, corr) -> PoolRequest:
        conf_fp = self._conf_fp(config)
        with self._lock:
            seq = self._seq.get(tenant, 0) + 1
            self._seq[tenant] = seq
        req = PoolRequest(
            tenant=tenant,
            st=st,
            config=config,
            conf_fp=conf_fp,
            pack_meta=pack_meta,
            corr=corr,
            seq=seq,
            shape=pack_shape_key(
                st, conf_fp, from_config(config).actions,
                decode_caps=getattr(pack_meta, "decode_caps", None),
            ),
            t_submit=self.now(),
        )
        if self.admission is not None and self.admission.should_shed(tenant):
            burn = self.admission.burn(tenant)
            reason_fn = getattr(self.admission, "shed_reason", None)
            entry = {
                "tenant": tenant,
                "seq": seq,
                "cycle": self.cycle,
                "corr": req.corr,
                "reason": reason_fn(tenant) if callable(reason_fn) else "slo_burn",
                "burn": None if burn is None else round(burn, 3),
            }
            with self._lock:
                self.shed_log.append(entry)
                del self.shed_log[: -self.log_capacity]
            self._log(req, outcome="shed", replica=None, resident=None)
            self._count(tenant, "shed")
            req.error = PoolShed(
                f"tenant {tenant} shed: sustained latency burn "
                f"{entry['burn']} over its error budget"
            )
        return req

    # ---- serving ----

    def _chunks(self, reqs: List[PoolRequest]) -> List[List[PoolRequest]]:
        """One flush -> shape-compatible groups of at most ``max_batch``
        requests, in shape-key order: the one grouping rule of the inline
        and the threaded path."""
        groups: Dict[str, List[PoolRequest]] = {}
        for r in reqs:
            groups.setdefault(r.shape, []).append(r)
        out: List[List[PoolRequest]] = []
        for shape in sorted(groups):
            group = groups[shape]
            for i in range(0, len(group), self.max_batch):
                out.append(group[i : i + self.max_batch])
        return out

    def _process(self, reqs: List[PoolRequest]) -> None:
        """Group a flush by compatibility key and serve each group (one
        batched launch a group)."""
        for chunk in self._chunks(reqs):
            self._serve_group(chunk, excluded=set())

    def _dispatch_loop(self) -> None:
        # the condition wait is the one sanctioned park of this thread
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if self._stop and not self._queue:
                    return
                # bounded-delay fill: wait for min_fill requests, but
                # never past the delay budget
                deadline = time.monotonic() + self.batch_delay_s
                while len(self._queue) < max(self.min_fill, 1):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop:
                        break
                    self._cond.wait(remaining)
                batch, self._queue = self._queue, []
            for chunk in self._chunks(batch):
                replica = self._route(chunk, excluded=set())
                if replica is None:
                    # _serve_group splits a cross-partitioned multi-tenant
                    # group per tenant (rare: one worker runs it)
                    self._workers[0].submit(self._serve_split, chunk)
                    continue
                with self._lock:
                    replica.inflight += len(chunk)
                self._gauge_inflight(replica)
                self._workers[replica.index].submit(
                    self._serve_routed, replica, chunk
                )

    def _serve_split(self, group: List[PoolRequest]) -> None:
        """Worker entry for an unroutable group; any escape resolves the
        requests like _serve_routed."""
        try:
            self._serve_group(group, excluded=set())
        except Exception as err:
            self._resolve_error(group, err)

    def _serve_routed(self, replica: PoolReplica, group: List[PoolRequest]) -> None:
        """Replica-worker entry: serve the pre-routed group, rerouting on a
        mid-decide replica loss.  ANY escape resolves the group's
        unresolved requests with the real error."""
        try:
            self._serve_on(replica, group, excluded=set())
        except Exception as err:
            self._resolve_error(group, err)
        finally:
            with self._lock:
                replica.inflight -= len(group)
            self._gauge_inflight(replica)

    def _route(
        self, group: List[PoolRequest], excluded: set
    ) -> Optional[PoolReplica]:
        """Least-loaded over alive, non-partitioned replicas; a
        round-robin tiebreak keeps the spread deterministic when idle."""
        tenants = {r.tenant for r in group}
        with self._lock:
            rr = self._rr
            self._rr += 1
            eligible = [
                r
                for r in self.replicas
                if r.index not in excluded
                and not any(
                    (r.index, t) in self._partitions for t in tenants
                )
            ]
            if not eligible:
                return None
            return min(
                eligible,
                key=lambda r: (r.inflight, (r.index - rr) % len(self.replicas)),
            )

    def _fail_group(self, group: List[PoolRequest]) -> None:
        for req in group:
            req.error = PoolUnavailable(
                f"no replica can serve tenant {req.tenant} "
                f"(partitions/exclusions cover the pool)"
            )
            self._log(req, outcome="error", replica=None, resident=None)
            self._count(req.tenant, "error")
            req.event.set()

    def _resolve_error(self, group: List[PoolRequest], err: BaseException) -> None:
        """A serve attempt died (a launch error, a resident lost to a
        concurrent kill): resolve every unresolved request with the REAL
        error, so decide() re-raises it."""
        for req in group:
            if req.event.is_set():
                continue
            req.error = err
            self._log(req, outcome="error", replica=None, resident=None)
            self._count(req.tenant, "error")
            req.event.set()

    def _serve_group(self, group: List[PoolRequest], excluded: set) -> None:
        replica = self._route(group, excluded)
        if replica is None:
            # a multi-tenant group can be cross-partitioned while every
            # tenant still has a serveable replica alone: give up
            # batching, not service
            tenants = sorted({r.tenant for r in group})
            if len(tenants) > 1:
                for t in tenants:
                    self._serve_group(
                        [r for r in group if r.tenant == t], set(excluded)
                    )
                return
            self._fail_group(group)
            return
        with self._lock:
            replica.inflight += len(group)
        self._gauge_inflight(replica)
        try:
            self._serve_on(replica, group, excluded)
        except Exception as err:
            self._resolve_error(group, err)
        finally:
            with self._lock:
                replica.inflight -= len(group)
            self._gauge_inflight(replica)

    def _serve_on(
        self, replica: PoolReplica, group: List[PoolRequest], excluded: set
    ) -> None:
        """Serve one shape-compatible group on ``replica``: the fault
        seam, the delta fan-out to the whole fleet, one batched launch,
        de-stack.  A mid-decide replica loss reroutes the group."""
        if self.fault_hook is not None:
            try:
                self.fault_hook(replica, group)
            except _ReplicaLost as lost:
                excluded.add(lost.replica_index)
                self._serve_group(group, excluded)
                return
        # fan-out replication: every reachable replica updates every
        # tenant's resident pack, so the NEXT cycle can route anywhere
        seeded: Dict[str, str] = {}
        for req in group:
            for r in self.replicas:
                if self.is_partitioned(r.index, req.tenant):
                    continue
                mode = r.apply_delta(req.tenant, req.st, req.pack_meta)
                if r is replica:
                    seeded[req.tenant] = mode
                    req.upload_mode, req.upload_bytes = r.upload_of(req.tenant)
                if mode == "full" and req.pack_meta is not None and req.pack_meta.base_key is not None:
                    # the delta's base was not resident here: a re-seed
                    self._metrics().counter_add(
                        "pool_pack_reseeds_total", labels={"replica": r.id}
                    )
        packs = []
        residents = []
        try:
            for req in group:
                key, pack = replica.resident(req.tenant)
                residents.append(key)
                packs.append(pack)
        except KeyError:
            # a concurrent kill_replica() cleared the packs between the
            # fan-out and this read: the replica is lost to THIS group
            excluded.add(replica.index)
            self._serve_group(group, excluded)
            return
        caps = getattr(group[0].pack_meta, "decode_caps", None)
        # the keyword only when caps are in play: decide_batch(packs,
        # config) is an override seam (tests replace it with two-argument
        # callables)
        decs, launch_ms = (
            replica.decide_batch(tuple(packs), group[0].config, decode_caps=caps)
            if caps is not None
            else replica.decide_batch(tuple(packs), group[0].config)
        )
        self._metrics().observe("pool_batch_size", float(len(group)))
        batch_id = self._record_batch(replica, group, launch_ms)
        for req, dec, resident_key in zip(group, decs, residents):
            req.decisions = dec
            req.kernel_ms = launch_ms
            req.replica = replica.id
            req.batch = len(group)
            req.batch_id = batch_id
            req.reseeded = (
                seeded.get(req.tenant) == "full"
                and req.pack_meta is not None
                and req.pack_meta.base_key is not None
            )
            # claim the request atomically against a timing-out decide()
            with self._lock:
                late = req.abandoned
                if not late:
                    req.event.set()
            if late:
                # the tenant already counted this cycle as an error: a late
                # completion is neither served nor an admission sample
                self._log(
                    req, outcome="abandoned",
                    replica=replica.id, resident=resident_key,
                )
                self._count(req.tenant, "error")
                req.event.set()
                continue
            latency_ms = max((self.now() - req.t_submit) * 1000, 0.0)
            if self.admission is not None:
                self.admission.observe(req.tenant, latency_ms)
            outcome = "resent" if req.reseeded else "served"
            self._log(req, outcome=outcome, replica=replica.id, resident=resident_key)
            self._count(req.tenant, outcome)

    def _record_batch(
        self, replica: PoolReplica, group: List[PoolRequest], launch_ms: float
    ) -> str:
        """Mint the launch's ``batch_id`` and account the launch under the
        reference's bucket label (:func:`_pad_bucket`): nothing is padded
        (occupancy 1.0, padding 0), and ``compile`` marks the shape key's
        first launch in the process."""
        n = len(group)
        with self._lock:
            self._batch_seq += 1
            batch_id = f"batch-{self._batch_seq:06d}"
            compiled = group[0].shape not in self._warm_buckets
            self._warm_buckets.add(group[0].shape)
        m = self._metrics()
        bucket = {"bucket": str(_pad_bucket(n))}
        m.gauge_set("pool_batch_occupancy", 1.0, labels=bucket)
        m.counter_add("pool_batch_padding_total", 0.0, labels=bucket)
        m.counter_add("pool_batch_launches_total",
                      labels={**bucket, "compile": "compile" if compiled else "reuse"})
        return batch_id

    def _log(
        self, req: PoolRequest, outcome: str, replica: Optional[str],
        resident: Optional[str],
    ) -> None:
        if self.log_drop_served and outcome in ("served", "resent"):
            return  # sensitivity seam: a checker of the log MUST breach
        entry = {
            "tenant": req.tenant,
            "seq": req.seq,
            "cycle": self.cycle,
            "corr": req.corr,
            "replica": replica,
            "outcome": outcome,
            "batch": req.batch,
            "batch_id": req.batch_id,
            "epoch": req.pack_meta.key if req.pack_meta is not None else None,
            "resident": resident,
        }
        with self._lock:
            self.decision_log.append(entry)
            del self.decision_log[: -self.log_capacity]

    def log_for(self, tenant: str, cycle: Optional[int] = None) -> List[dict]:
        with self._lock:
            return [
                e
                for e in self.decision_log
                if e["tenant"] == tenant
                and (cycle is None or e["cycle"] == cycle)
            ]

    def close(self) -> None:
        if self._dispatcher is not None:
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            self._dispatcher.join(timeout=10.0)
            for w in self._workers or ():
                w.shutdown(wait=True)


class PoolClient:
    """The per-tenant decider facade: a Scheduler / Session decider whose
    decide() routes through a shared :class:`DecisionPool`.  It consumes
    the HOST pack and its PackMeta (the pool fans the delta out itself),
    with one decide in flight per tenant at a time.  ``last_mode`` /
    ``last_upload_bytes`` are the serving replica's upload of the last
    epoch."""

    wants_device_pack = False
    # PackMeta.decode_caps join the shape key and reach the batched launch
    supports_decode_caps = True

    def __init__(self, pool: DecisionPool, tenant: str):
        self.pool = pool
        self.tenant = tenant
        self.last_action_ms: Dict[str, float] = {}
        self.last_action_rounds: Dict[str, int] = {}
        self.last_kernel_ms = 0.0
        self.last_mode = "none"
        self.last_upload_bytes = 0

    def decide(self, st, config, pack_meta=None) -> Tuple[object, float]:
        dec, kernel_ms, req = self.pool.decide_request(
            self.tenant, st, config, pack_meta=pack_meta
        )
        self.last_kernel_ms = kernel_ms
        self.last_mode, self.last_upload_bytes = req.upload_mode, req.upload_bytes
        return dec, kernel_ms

    def close(self) -> None:
        pass


def np_equal_decisions(a, b) -> bool:
    """Bit equality of two CycleDecisions (host or device fields)."""
    for f in dataclasses.fields(type(a)):
        x, y = getattr(a, f.name), getattr(b, f.name)
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            return False
    return True
