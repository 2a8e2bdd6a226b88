"""The incremental snapshot plane: the arena that keeps the host pack
alive across cycles, and the device-resident pack it feeds (the port of
kube_arbitrator_tpu/cache/arena.py).

:class:`SnapshotArena` (the reference's :376-1031) owns persistent numpy
arrays for every pack field plus the stable ordinal maps, and is the
delta sink a ``SimCluster`` publishes into (``backend.delta_sink``):
``task_dirty`` / ``task_dirty_rows`` / ``node_dirty`` for row-level churn
(binds, evicts, status flips), ``structural`` for anything that changes
set membership or an equivalence-class universe.  The delta path
refreshes dirty rows from the live objects and recomputes the cheap
derived planes (task groups, the reclaim canon pack, job / queue /
others aggregates) with vectorized numpy; any guard trip (set drift, a
changed predicate or node signature, a new host port, any pod-affinity
term) rebuilds the pack with :func:`~.snapshot.build_snapshot`.  The
delta path must give exactly the pack a fresh build would:
:meth:`SnapshotArena.verify` rebuilds and compares field for field
(every ``verify_every``-th delta pack does so itself) and raises
:class:`ArenaDivergence` on any difference.  Each pack comes with a
:class:`PackMeta` (epoch key, base key, changed fields), which the
decider turns into a delta upload.

A scheduler's arena hands each cycle a host pack, its epoch key, the key
of the pack it was diffed against and the fields that changed since
(:class:`PackMeta`, the reference's :102-119).  :class:`DeviceResident`
(the reference's ``_DeviceResident``, :182-250) keeps one buffer per
pack field on the device across epochs:

* **reuse** — the same key on the same device uploads 0 bytes;
* **full** — no resident yet, another device, no base, or a base that
  is not the resident's key: every field is placed anew;
* **delta** — the statics (``rv_window``) are taken as given; an
  unchanged field keeps its buffer; a field whose diff is
  ``"full"`` (its shape or dtype moved) or whose changed rows are more
  than half its rows is placed whole; the other changed fields' rows are
  written in place, all of them in one K18 launch on the card, from the
  resident's own :class:`RowScatterPlan` (its staging buffers reused
  epoch after epoch, each field's buffer bound when it is placed whole).

Three deliberate departures from the reference: on the CPU the rows are
scattered too (through K18's plain version), where the reference
re-places whole fields to spare a JAX compile per scatter shape; the
rows are not padded to compile buckets (``_pad_rows``), which only JAX
needs; and a moved static is no reason for a full upload, since no
compiled program is keyed by it here (the rv_* arrays whose shape moved
with it are placed whole by the field rule above).

The pipeline plane's journal tee is the reference's (its :401-484): with
``arena.journal`` set (pipeline/journal.DeltaJournal, attached by the
pipelined executor), every sink call is mirrored into the journal before
the arena's own bookkeeping, even while the arena is marked structural.
Each pack is traced as the reference's is (``arena.delta`` /
``arena.rebuild`` / ``arena.verify`` / ``arena.diff`` spans) and counted
(``snapshot_full_rebuilds_total{reason}``, ``snapshot_delta_rows``).

Not ported: the arena's own device placement (``device_pack``, the
decider owns its :class:`DeviceResident`), the sharded resident
(``_ShardedResident``, ``device_pack_sharded``, ``shard_dirty_rows``)
and the chaos seams (``corrupt``, ``pick_clean_node_row``).
"""
from __future__ import annotations

import dataclasses
import uuid
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..api import resource as res
from ..api.types import TaskStatus
from ..ops.kernels.row_scatter import RowScatterPlan
from ..utils.metrics import metrics
from ..utils.tracing import tracer
from .snapshot import (
    HOST_SCHEMA,
    SCHEMA,
    HostPack,
    Snapshot,
    SnapshotIndex,
    SnapshotTensors,
    _bucket,
    _ports_mask,
    _property_signature,
    build_reclaim_pack,
    build_snapshot,
    group_signature,
    to_device_units,
)


@dataclasses.dataclass(frozen=True)
class PackMeta:
    """An epoch's pack key, the key it was diffed against (None: no
    usable base, ship everything), the fields changed since that base,
    and the tenant's own (bind_cap, evict_cap) decode-list caps (None:
    the global ``ops.cycle.decode_caps`` formula)."""

    key: str
    base_key: Optional[str]
    changed_fields: Tuple[str, ...]
    decode_caps: Optional[Tuple[int, int]] = None


# the pack's array fields (statics such as ``rv_window`` ride apart)
ARRAY_FIELDS: Tuple[str, ...] = tuple(SCHEMA)
# the host pack's array fields: ARRAY_FIELDS and the real-queue count
PACK_FIELDS: Tuple[str, ...] = tuple(HOST_SCHEMA)

Rows = Union[None, str, np.ndarray]


def changed_rows(a: np.ndarray, b: np.ndarray) -> Rows:
    """Row indices where ``a`` differs from ``b`` (same shape and dtype),
    ``"full"`` when they are not comparable row by row, or None when
    they are identical (the reference's ``_changed_rows``, :127-144)."""
    if (
        getattr(a, "shape", None) != getattr(b, "shape", None)
        or getattr(a, "dtype", None) != getattr(b, "dtype", None)
    ):
        return "full"
    if a.ndim == 0:
        return None if a == b else "full"
    d = a != b
    if d.ndim > 1:
        d = d.any(axis=tuple(range(1, d.ndim)))
    rows = np.nonzero(d)[0]
    if rows.size == 0:
        return None
    return rows


def changed_fields(prev: Mapping[str, object], new: Mapping[str, object]) -> Tuple[str, ...]:
    """The fields of pack ``new`` that differ from pack ``prev``'s: the
    array fields (one held by both packs is skipped unread) and the
    ``rv_window`` static, as a reference arena's PackMeta lists them."""
    out = [name for name in ARRAY_FIELDS
           if new[name] is not prev[name] and changed_rows(np.asarray(new[name]),
                                                           np.asarray(prev[name])) is not None]
    if int(new.get("rv_window", 0)) != int(prev.get("rv_window", 0)):
        out.append("rv_window")
    return tuple(sorted(out))


class DeviceResident:
    """The pack's fields resident on one device, updated by epoch.  It
    owns its buffers: nothing aliases the caller's numpy arrays."""

    def __init__(self):
        self.device: Optional[torch.device] = None
        self.key: Optional[str] = None
        self.arrays: Optional[Dict[str, torch.Tensor]] = None
        self.statics: Dict[str, object] = {}
        self.plan: Optional[RowScatterPlan] = None  # K18's, for self.device
        # the most recent update: "none" / "full" / "delta" / "reuse", the
        # bytes it sent (whole fields, or changed rows plus their i32
        # indices), and the fields whose rows it wrote in place (K18)
        self.last_upload_bytes = 0
        self.last_mode = "none"
        self.last_scattered: Tuple[str, ...] = ()

    def update(
        self,
        host: Mapping[str, np.ndarray],
        statics: Mapping[str, object],
        key: str,
        base_key: Optional[str],
        changed: Mapping[str, Rows],
        device: torch.device,
    ) -> SnapshotTensors:
        """The resident pack after epoch ``key``: ``host`` holds every
        array field, ``changed`` the rows of each field changed since
        ``base_key`` (absent or None: unchanged; ``"full"``: re-place)."""
        device = torch.device(device)
        if self.arrays is not None and self.key == key and self.device == device:
            self.last_upload_bytes, self.last_mode, self.last_scattered = 0, "reuse", ()
            return SnapshotTensors(**self.arrays, **self.statics)
        full = (
            self.arrays is None
            or self.device != device
            or base_key is None
            or self.key != base_key
        )
        arrays: Dict[str, torch.Tensor] = {} if full else dict(self.arrays)
        if self.plan is None or self.device != device:
            self.plan = RowScatterPlan(device)
        uploaded = 0
        changes = []
        for name in ARRAY_FIELDS:
            arr = np.asarray(host[name])
            rows = None if full else changed.get(name)
            if rows is None and not full:
                continue  # the resident buffer is current
            if full or isinstance(rows, str) or 2 * len(rows) > max(arr.shape[0], 1):
                arrays[name] = torch.from_numpy(np.array(arr)).to(device)
                uploaded += arr.nbytes
                if arr.ndim in (1, 2):
                    self.plan.place(name, arrays[name])
            else:
                changes.append((name, arr, rows))
        uploaded += self.plan(changes)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.device, self.key, self.arrays, self.statics = device, key, arrays, dict(statics)
        self.last_upload_bytes = uploaded
        self.last_mode = "full" if full else "delta"
        self.last_scattered = tuple(name for name, _, _ in changes)
        return SnapshotTensors(**arrays, **self.statics)

    def first_difference(self, host: Mapping[str, np.ndarray]) -> Optional[str]:
        """The first array field whose resident buffer differs from
        ``host``'s bit for bit (shape and dtype included), or None."""
        for name in ARRAY_FIELDS:
            got = (self.arrays or {}).get(name)
            want = np.asarray(host[name])
            if got is None:
                return name
            g = got.cpu().numpy()
            if g.dtype != want.dtype or g.shape != want.shape or g.tobytes() != want.tobytes():
                return name
        return None


# ---------------------------------------------------------------------------
# the arena

class ArenaDivergence(RuntimeError):
    """The incremental pack disagreed with a from-scratch rebuild — the
    delta path missed a mutation (or a backend failed to emit one).
    Fatal for the cycle; the arena poisons itself into a full rebuild so
    a supervisor that retries gets a correct (if slower) next cycle."""


class _StructuralFallback(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class SnapshotArena:
    """Incrementally maintained :class:`Snapshot` over a cluster backend.

    ``backend`` is anything with a ``.cluster`` (``SimCluster``); the
    arena installs itself as ``backend.delta_sink``
    so the backend's mutation paths publish deltas.  ``verify_every=N``
    re-derives the pack from scratch every N-th delta pack and asserts
    byte-identity (0 disables the periodic check; :meth:`verify` is
    always available)."""

    def __init__(
        self,
        backend,
        verify_every: int = 64,
    ):
        self.backend = backend
        self.verify_every = verify_every
        backend.delta_sink = self
        self.uid = uuid.uuid4().hex[:8]
        self.epoch = 0
        # speculation-window tee (pipeline plane): when attached, every
        # sink call below is mirrored into the journal BEFORE the arena's
        # own guards — the commit gate needs deltas even when the arena
        # is already marked structural.  None costs one attribute read.
        self.journal = None
        self.pack_meta: Optional[PackMeta] = None
        self.last_rebuild_reason: Optional[str] = None
        self.last_delta_rows = 0
        self._packs_since_verify = 0
        self._structural: Optional[str] = "seed"
        self._dirty_tasks: set = set()
        self._dirty_nodes: set = set()
        # working arenas (mutated in place on the delta path)
        self._w: Dict[str, np.ndarray] = {}
        self._statics: Dict[str, object] = {}
        # the last pack as shipped to consumers (diff base; fresh copies)
        self._shipped: Dict[str, np.ndarray] = {}
        self._shipped_statics: Optional[Dict[str, object]] = None
        self._changed: Dict[str, object] = {}
        # ordinal maps + guard caches (filled by _adopt)
        self._tasks: List = []
        self._uid_ord: Dict[str, int] = {}
        self._job_of_uid: Dict[str, str] = {}
        self._node_ord: Dict[str, int] = {}
        self._queue_uids: List[str] = []
        self._job_uids: List[str] = []
        self._node_names: List[str] = []
        self._task_sig: List[Tuple] = []
        self._task_ports_sig: List[Tuple] = []
        self._node_sig: List[Tuple] = []
        self._gkey_intern: Dict[Tuple, int] = {}
        self._task_gid: np.ndarray = np.zeros(0, np.int64)
        self._upos: Dict[int, int] = {}
        self._universe: List[int] = []
        self._aff_trivial = True

    @property
    def cluster(self):
        """The backend's live model, resolved per access (a backend may
        swap its ``ClusterInfo`` wholesale)."""
        return self.backend.cluster

    # ---- the delta sink surface (backends call these) ----

    def task_dirty(self, uid: str, node_name: str = "") -> None:
        """A task's row-level state may have changed (status, node,
        priority, resreq).  Structural changes must go through
        :meth:`structural` — but the pack-time guards catch a mis-filed
        one and fall back, so a conservative extra call here is always
        safe."""
        if self.journal is not None:
            self.journal.task_dirty(uid, node_name)
        if self._structural is None:
            self._dirty_tasks.add(uid)
            if node_name:
                self._dirty_nodes.add(node_name)

    def task_dirty_rows(self, uids, node_names=()) -> None:
        """Batched twin of :meth:`task_dirty`: ONE call for a whole
        event block's (or commit's) row dirt — parallel uid/node
        vectors; empty node entries mean "no node implicated" exactly
        like the scalar default.  Dirty-set semantics are identical to
        the equivalent scalar call sequence, so packs cannot tell which
        surface the producer used."""
        if self.journal is not None:
            self.journal.task_dirty_rows(uids, node_names)
        if self._structural is None:
            self._dirty_tasks.update(uids)
            self._dirty_nodes.update(n for n in node_names if n)

    def node_dirty(self, name: str) -> None:
        if self.journal is not None:
            self.journal.node_dirty(name)
        if self._structural is None:
            self._dirty_nodes.add(name)

    def structural(self, reason: str) -> None:
        """Set membership or an equivalence-class universe changed; the
        next pack rebuilds from scratch.  First reason wins
        (``last_rebuild_reason``)."""
        if self.journal is not None:
            self.journal.structural_event(reason)
        if self._structural is None:
            self._structural = reason
            self._dirty_tasks.clear()
            self._dirty_nodes.clear()

    # ---- producer ----

    def snapshot(self) -> Snapshot:
        """The pack for this cycle: delta-maintained when possible, full
        rebuild on any structural doubt.  Returns a :class:`Snapshot`
        whose tensors are a :class:`HostPack` of FRESH arrays (stable
        after later packs)."""
        tr = tracer()
        m = metrics()
        reason = self._structural
        check = False
        if reason is None and self.verify_every:
            self._packs_since_verify += 1
            if self._packs_since_verify >= self.verify_every:
                check, self._packs_since_verify = True, 0
        if reason is None:
            try:
                with tr.span("arena.delta", tasks=len(self._dirty_tasks),
                             nodes=len(self._dirty_nodes)):
                    index = self._apply_deltas()
            except _StructuralFallback as fb:
                reason = fb.reason
        if reason is not None:
            with tr.span("arena.rebuild", reason=reason):
                index = self._rebuild()
            m.counter_add("snapshot_full_rebuilds_total", labels={"reason": reason})
        self.last_rebuild_reason = reason
        # pending deltas are consumed (applied or subsumed by a rebuild):
        # clear BEFORE the epoch check so verify()'s own drain guard sees
        # a quiescent arena (it would otherwise re-enter snapshot())
        self._structural = None
        self._dirty_tasks.clear()
        self._dirty_nodes.clear()
        if reason is None and check:
            # the epoch check: a from-scratch rebuild must agree with the
            # delta-maintained arenas byte for byte (raises otherwise)
            with tr.span("arena.verify"):
                self.verify()
            m.counter_add("snapshot_full_rebuilds_total", labels={"reason": "verify"})

        with tr.span("arena.diff"):
            shipped, changed, delta_rows = self._diff_and_ship()
            # static fields (rv_window) shape the rv_* arrays' window and CAN
            # move on a pure delta cycle: they must ride changed_fields too,
            # or a delta upload would patch the rv arrays while the resident
            # keeps the stale static
            if self._shipped_statics is not None:
                for name, val in self._statics.items():
                    if self._shipped_statics.get(name) != val:
                        changed[name] = "full"
                        delta_rows += 1
            self._shipped_statics = dict(self._statics)
        base_key = f"{self.uid}:{self.epoch}" if self._shipped else None
        if changed or not self._shipped:
            self.epoch += 1
        key = f"{self.uid}:{self.epoch}"
        self._shipped = shipped
        self._changed = changed
        self.last_delta_rows = delta_rows
        self.pack_meta = PackMeta(
            key=key, base_key=base_key, changed_fields=tuple(sorted(changed)),
        )
        m.gauge_set("snapshot_delta_rows", float(delta_rows))
        tensors = HostPack(**shipped, **self._statics)
        return Snapshot(tensors=tensors, index=index)

    def verify(self) -> None:
        """Rebuild from scratch and assert the working arenas are
        byte-identical — the arena's runtime twin.  Raises
        :class:`ArenaDivergence` (and poisons the arena into a rebuild)
        on any mismatch.

        Deltas emitted since the last pack (e.g. the actuation that
        followed it) are drained into a pack first — they are published
        but not yet applied, and comparing un-refreshed arenas against
        the moved-on cluster would report a false divergence."""
        if self._structural is not None or self._dirty_tasks or self._dirty_nodes:
            self.snapshot()
        fresh = build_snapshot(self.cluster).tensors
        bad = []
        for f in dataclasses.fields(HostPack):
            a = self._w.get(f.name, self._statics.get(f.name))
            b = getattr(fresh, f.name)
            if f.name not in self._w:  # a static (rv_window)
                if a != b:
                    bad.append(f"{f.name}: arena {a} != rebuild {b}")
                continue
            if (
                a.shape != b.shape
                or a.dtype != b.dtype
                or not np.array_equal(a, b)
            ):
                n = (
                    int((a != b).sum())
                    if a.shape == b.shape else -1
                )
                bad.append(
                    f"{f.name}: arena {a.dtype}{list(a.shape)} != rebuild "
                    f"{b.dtype}{list(b.shape)} ({n} cells differ)"
                )
        if bad:
            self._structural = "divergence"
            raise ArenaDivergence(
                "incremental pack diverged from full rebuild — a backend "
                "mutation was not published to the delta sink: "
                + "; ".join(bad[:5])
                + (f" (+{len(bad) - 5} more fields)" if len(bad) > 5 else "")
            )

    # ---- internals ----

    def _diff_and_ship(self):
        shipped: Dict[str, np.ndarray] = {}
        changed: Dict[str, object] = {}
        delta_rows = 0
        for name in PACK_FIELDS:
            a = self._w[name]
            prev = self._shipped.get(name)
            if prev is not None:
                rows = changed_rows(a, prev)
                if rows is not None:
                    changed[name] = rows
                    if isinstance(rows, np.ndarray):
                        delta_rows += len(rows)
                    else:
                        delta_rows += a.shape[0] if a.ndim else 1
            shipped[name] = a.copy()
        return shipped, changed, delta_rows

    def _rebuild(self) -> SnapshotIndex:
        snap = build_snapshot(self.cluster)
        self._adopt(snap)
        return snap.index

    def _adopt(self, snap: Snapshot) -> None:
        t = snap.tensors
        self._w = {
            name: np.array(getattr(t, name), copy=True)
            for name in PACK_FIELDS
        }
        self._statics = {"rv_window": t.rv_window}
        idx = snap.index
        self._tasks = list(idx.tasks)
        self._uid_ord = {tk.uid: tk.ordinal for tk in idx.tasks}
        self._job_of_uid = {tk.uid: tk.job_uid for tk in idx.tasks}
        self._node_ord = {n.name: n.ordinal for n in idx.nodes}
        self._queue_uids = [q.uid for q in idx.queues]
        self._job_uids = [j.uid for j in idx.jobs]
        self._node_names = [n.name for n in idx.nodes]
        self._universe = list(idx.port_universe)
        self._upos = {p: i for i, p in enumerate(self._universe)}
        self._node_sig = [_property_signature(n) for n in idx.nodes]
        self._aff_trivial = not any(tk.affinity_terms for tk in idx.tasks)
        # per-task guard caches + interned group keys (trivial-affinity
        # form: pa_class/terms contribute nothing — see module docstring)
        # raw signature INPUTS (immutable copies), so the refresh guard is
        # a value compare instead of re-deriving the canonical signature
        # per dirty task — at 25k dirty rows that re-derivation alone cost
        # more than the whole vectorized group/reclaim recompute
        self._task_sig = [
            (dict(tk.node_selector), tuple(tk.node_affinity),
             tuple(tk.tolerations), tk.volume_zone)
            for tk in idx.tasks
        ]
        self._task_ports_sig = [tuple(tk.host_ports) for tk in idx.tasks]
        self._task_resreq_bytes = [tk.resreq.tobytes() for tk in idx.tasks]
        self._task_priority = [tk.priority for tk in idx.tasks]
        self._gkey_intern = {}
        task_job = self._w["task_job"]
        task_klass = self._w["task_klass"]
        gid = np.zeros(len(idx.tasks), np.int64)
        if self._aff_trivial:
            for tk in idx.tasks:
                key = group_signature(
                    tk, task_job[tk.ordinal], task_klass[tk.ordinal]
                )
                gid[tk.ordinal] = self._gkey_intern.setdefault(
                    key, len(self._gkey_intern)
                )
        self._task_gid = gid

    def _apply_deltas(self) -> SnapshotIndex:
        cluster = self.cluster
        if not self._aff_trivial:
            # "existing pods per domain" counts move on every bind: the
            # affinity encoding is not delta-maintained (yet)
            raise _StructuralFallback("pod_affinity")
        # set-membership safety net: a backend that forgot to emit a
        # structural event for an add/remove still falls back here
        if (
            len(cluster.queues) != len(self._queue_uids)
            or len(cluster.jobs) != len(self._job_uids)
            or len(cluster.nodes) != len(self._node_names)
            or sum(len(j.tasks) for j in cluster.jobs.values()) != len(self._tasks)
        ):
            raise _StructuralFallback("set_drift")
        try:
            queues = [cluster.queues[u] for u in self._queue_uids]
            jobs = [cluster.jobs[u] for u in self._job_uids]
            nodes = [cluster.nodes[n] for n in self._node_names]
        except KeyError:
            raise _StructuralFallback("set_drift") from None
        for i, q in enumerate(queues):
            q.ordinal = i
        for i, j in enumerate(jobs):
            j.ordinal = i
        for i, n in enumerate(nodes):
            n.ordinal = i

        self._refresh_tasks(cluster)
        self._refresh_nodes(nodes)
        self._refresh_jobs_queues(jobs, queues)
        w = self._w
        w["others_used"] = (
            to_device_units(res.sum_resources(tk.resreq for tk in cluster.others))
            if cluster.others
            else np.zeros(w["others_used"].shape[0], dtype=np.float32)
        )
        w["n_valid_queues"] = np.int32(len(queues))
        self._recompute_groups()
        self._recompute_reclaim()
        return SnapshotIndex(
            tasks=self._tasks, nodes=nodes, jobs=jobs, queues=queues,
            port_universe=self._universe,
        )

    def _refresh_tasks(self, cluster) -> None:
        w = self._w
        node_ord = self._node_ord
        for uid in self._dirty_tasks:
            juid = self._job_of_uid.get(uid)
            job = cluster.jobs.get(juid) if juid is not None else None
            tk = job.tasks.get(uid) if job is not None else None
            if tk is None:
                raise _StructuralFallback("task_removed")
            o = self._uid_ord[uid]
            if tk.affinity_terms:
                raise _StructuralFallback("pod_affinity")
            if tuple(tk.host_ports) != self._task_ports_sig[o]:
                raise _StructuralFallback("port_universe")
            sig = self._task_sig[o]
            if (
                tk.node_selector != sig[0]
                or tk.node_affinity != sig[1]
                or tuple(tk.tolerations) != sig[2]
                or tk.volume_zone != sig[3]
            ):
                # class ids are first-occurrence-ordered; any signature
                # change can reshuffle the whole class table.  The cached
                # side holds copies, so a replaced object with equal
                # constraints still compares equal here.
                raise _StructuralFallback("predicate_signature")
            w["task_status"][o] = int(tk.status)
            w["task_node"][o] = node_ord.get(tk.node_name, -1)
            # resreq/priority feed the group key; recompute it (and the
            # derived row values) only when they actually moved — binds
            # and evicts, the dominant delta, change neither
            rb = tk.resreq.tobytes()
            if rb != self._task_resreq_bytes[o] or tk.priority != self._task_priority[o]:
                self._task_resreq_bytes[o] = rb
                self._task_priority[o] = tk.priority
                w["task_resreq"][o] = to_device_units(tk.resreq)
                w["task_priority"][o] = tk.priority
                w["task_best_effort"][o] = tk.best_effort
                key = group_signature(tk, w["task_job"][o], w["task_klass"][o])
                self._task_gid[o] = self._gkey_intern.setdefault(
                    key, len(self._gkey_intern)
                )
            tk.ordinal = o
            self._tasks[o] = tk

    def _refresh_nodes(self, nodes) -> None:
        w = self._w
        dirty = []
        for name in self._dirty_nodes:
            o = self._node_ord.get(name)
            if o is None:
                raise _StructuralFallback("node_added")
            n = nodes[o]
            if _property_signature(n) != self._node_sig[o]:
                raise _StructuralFallback("node_signature")
            dirty.append((o, n))
            w["node_max_tasks"][o] = n.max_tasks
            w["node_num_tasks"][o] = len(n.tasks)
            mask = np.zeros(w["node_ports"].shape[1], dtype=np.int32)
            for tk in n.tasks.values():
                if tk.host_ports:
                    if any(p not in self._upos for p in tk.host_ports):
                        raise _StructuralFallback("port_universe")
                    mask |= _ports_mask(tk.host_ports, self._upos)
            w["node_ports"][o] = mask
            w["node_unsched"][o] = n.unschedulable
        if dirty:
            # one vectorized f64->device-units pass for all dirty nodes
            # (still the exact per-row to_device_units result: the scale
            # multiply and f32 cast are elementwise)
            ords = np.fromiter((o for o, _ in dirty), np.int64, len(dirty))
            for field, attr in (
                ("node_idle", "idle"),
                ("node_releasing", "releasing"),
                ("node_alloc", "allocatable"),
            ):
                rows = np.stack([getattr(n, attr) for _, n in dirty])
                w[field][ords] = to_device_units(rows)

    def _refresh_jobs_queues(self, jobs, queues) -> None:
        w = self._w
        queue_ord = {q.uid: q.ordinal for q in queues}
        for rank, j in enumerate(sorted(jobs, key=lambda j: (j.creation_ts, j.uid))):
            w["job_creation_rank"][j.ordinal] = rank
        for j in jobs:
            w["job_queue"][j.ordinal] = queue_ord.get(j.queue_uid, 0)
            w["job_min_available"][j.ordinal] = j.min_available
            w["job_priority"][j.ordinal] = j.priority
            w["job_valid"][j.ordinal] = j.queue_uid in queue_ord
        for q in queues:
            w["queue_weight"][q.ordinal] = float(q.weight)
            w["queue_valid"][q.ordinal] = True

    def _recompute_groups(self) -> None:
        """The task-group plane, vectorized: byte-identical to
        build_snapshot's per-pending-task loop.  Group ordinals are
        first-appearance order of the (interned) group key over pending
        tasks in ordinal order; members sort by uid rank, which within
        one job's tasks IS ordinal order."""
        w = self._w
        T = w["task_status"].shape[0]
        R = w["task_resreq"].shape[1]
        W = w["task_ports"].shape[1]
        pending = (
            (w["task_status"] == int(TaskStatus.PENDING)) & w["task_valid"]
        )
        pend = np.nonzero(pending)[0]
        ids = self._task_gid[pend] if pend.size else np.zeros(0, np.int64)
        uniq, first, inv = np.unique(ids, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        gord = np.empty(len(uniq), np.int64)
        gord[order] = np.arange(len(uniq))
        g_of_pend = gord[inv]
        n_groups = len(uniq)
        G = _bucket(n_groups, 32, 32, key="groups")

        task_group = np.full(T, -1, dtype=np.int32)
        task_group_rank = np.zeros(T, dtype=np.int32)
        task_group[pend] = g_of_pend
        if pend.size:
            # rank within group in scan (== uid) order
            counts = np.bincount(g_of_pend, minlength=n_groups)
            starts = np.zeros(n_groups, np.int64)
            starts[1:] = np.cumsum(counts)[:-1]
            by_g = np.argsort(g_of_pend, kind="stable")
            ranks_sorted = np.arange(pend.size) - starts[g_of_pend[by_g]]
            ranks = np.empty(pend.size, np.int64)
            ranks[by_g] = ranks_sorted
            task_group_rank[pend] = ranks
        w["task_group"] = task_group
        w["task_group_rank"] = task_group_rank

        rep = pend[first[order]] if pend.size else np.zeros(0, np.int64)
        for name, shape, dtype in (
            ("group_job", (G,), np.int32),
            ("group_resreq", (G, R), np.float32),
            ("group_klass", (G,), np.int32),
            ("group_ports", (G, W), np.int32),
            ("group_size", (G,), np.int32),
            ("group_priority", (G,), np.int32),
            ("group_uid_rank", (G,), np.int32),
            ("group_best_effort", (G,), bool),
            ("group_valid", (G,), bool),
            ("group_pa_class", (G,), np.int32),
        ):
            w[name] = np.zeros(shape, dtype=dtype)
        if n_groups:
            w["group_job"][:n_groups] = w["task_job"][rep]
            w["group_resreq"][:n_groups] = w["task_resreq"][rep]
            w["group_klass"][:n_groups] = w["task_klass"][rep]
            w["group_ports"][:n_groups] = w["task_ports"][rep]
            w["group_size"][:n_groups] = np.bincount(
                g_of_pend, minlength=n_groups
            )
            w["group_priority"][:n_groups] = w["task_priority"][rep]
            w["group_uid_rank"][:n_groups] = w["task_uid_rank"][rep]
            w["group_best_effort"][:n_groups] = w["task_best_effort"][rep]
            w["group_valid"][:n_groups] = True
            w["group_pa_class"][:n_groups] = w["task_pa_class"][rep]
        # trivial-affinity term axes are zero-width at any G
        w["group_aff_terms"] = np.full((G, 0), -1, dtype=np.int32)
        w["group_anti_terms"] = np.full((G, 0), -1, dtype=np.int32)

    def _recompute_reclaim(self) -> None:
        w = self._w
        rv = build_reclaim_pack(
            w["task_status"], w["task_node"], w["task_valid"], w["task_job"],
            w["task_priority"], w["task_uid_rank"], w["job_queue"],
            w["node_valid"].shape[0], sticky=True,
        )
        self._statics["rv_window"] = rv.pop("rv_window")
        w.update(rv)
