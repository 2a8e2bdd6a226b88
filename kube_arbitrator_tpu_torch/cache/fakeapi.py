"""In-memory fake Kubernetes apiserver: the list/watch + actuation test
double for the live-cluster plane (the port's copy of
kube_arbitrator_tpu/cache/fakeapi.py; both take the same JSON dicts and
write the same recorded streams).

Plays the role the apiserver plays for the reference's generated clientset
and informers (``pkg/client/``, ``pkg/scheduler/cache/cache.go:225-306``):
an object store per resource kind with monotonically increasing resource
versions, pull-based watch streams, and the three actuation verbs the
scheduler issues — POST pod binding (``cache.go:88-104`` DefaultBinder),
DELETE pod (``:106-123`` DefaultEvictor), PUT PodGroup status (``:665-675``
StatusUpdater).  Objects are plain JSON-shaped dicts, so a recorded event
log round-trips through JSONL for watch-stream replay fixtures.
"""
from __future__ import annotations

import copy
import json
from typing import Dict, Iterable, List, Optional, Tuple

RESOURCES = (
    "pods",
    "nodes",
    "podgroups",
    "queues",
    "namespaces",
    "pdbs",
    # the volume plane (cache.go:230-238 wires a volumebinder over PV/PVC/
    # StorageClass informers, registrations :288-306): PVC-backed pod
    # volumes resolve through these to zone + attach constraints
    "persistentvolumes",
    "persistentvolumeclaims",
    "storageclasses",
    # the leader-election resourcelock kind (server.go:102-115 uses a
    # ConfigMap resourcelock); the scheduler cache ignores these events
    "configmaps",
)

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class ApiError(RuntimeError):
    """A failed REST call (non-2xx) — triggers the caller's errTasks
    resync path, like a failed POST bind (cache.go:519-547).

    ``status`` carries the HTTP status code across the wire so clients
    can branch on semantics (404 vs 409) instead of message prose."""

    def __init__(self, message: str, status: int = 422):
        super().__init__(message)
        self.status = status


class GoneError(ApiError):
    """410 Gone: the requested resourceVersion predates the event-log
    compaction horizon.  A real apiserver keeps a bounded etcd watch
    window and answers a too-old watch with 410; client-go informers
    respond with a full relist + re-watch.  :class:`cache.live.LiveCache`
    does the same (``_reset_model`` + LIST)."""

    def __init__(self, message: str):
        super().__init__(message, status=410)


def _key(obj: dict) -> Tuple[str, str]:
    md = obj.get("metadata", {})
    return md.get("namespace", ""), md["name"]


class FakeApiServer:
    """Object store + event log.  Watches are pull-based: a client asks for
    events after a resourceVersion; the informer pump drains them."""

    def __init__(self) -> None:
        self._store: Dict[str, Dict[Tuple[str, str], dict]] = {r: {} for r in RESOURCES}
        self._rv = 0
        # (rv, resource, type, object-copy)
        self.event_log: List[Tuple[int, str, str, dict]] = []
        # watch-window compaction horizon: events with rv <= this are gone
        # from the log; a watch from below it gets a 410 GoneError
        self._compacted_rv = 0
        # failure injection: uids whose bind/delete/status calls raise
        self.fail_bind_uids: set = set()
        self.fail_delete_uids: set = set()
        # kubelet emulation: POST bind also moves the pod to Running,
        # producing the MODIFIED watch event a real cluster would
        self.auto_run_bound_pods = True

    # ---- REST verbs ----

    def _bump(self, resource: str, etype: str, obj: dict) -> None:
        self._rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
        # the scheduler cache declaredly ignores configmaps (the lock
        # kind), and lease renewals write one every few seconds forever —
        # logging them would grow the never-compacted event log and every
        # watch_all scan without bound
        if resource != "configmaps":
            self.event_log.append((self._rv, resource, etype, copy.deepcopy(obj)))

    def create(self, resource: str, obj: dict) -> dict:
        k = _key(obj)
        if k in self._store[resource]:
            raise ApiError(f"{resource} {k} already exists", status=409)
        obj = copy.deepcopy(obj)
        self._store[resource][k] = obj
        self._bump(resource, ADDED, obj)
        return copy.deepcopy(obj)

    def update(self, resource: str, obj: dict, expect_rv: Optional[str] = None) -> dict:
        """PUT; ``expect_rv`` is the optimistic-concurrency precondition
        (metadata.resourceVersion match) the reference's resourcelock
        leader election relies on (server.go:102-125 via client-go
        resourcelock CAS updates) — mismatch is a 409 Conflict."""
        k = _key(obj)
        cur = self._store[resource].get(k)
        if cur is None:
            raise ApiError(f"{resource} {k} not found", status=404)
        self._check_rv(cur, resource, k, expect_rv)
        obj = copy.deepcopy(obj)
        self._store[resource][k] = obj
        self._bump(resource, MODIFIED, obj)
        return copy.deepcopy(obj)

    @staticmethod
    def _check_rv(cur: dict, resource: str, k, expect_rv: Optional[str]) -> None:
        """Optimistic-concurrency precondition shared by PUT and DELETE."""
        if expect_rv is None:
            return
        have = cur.get("metadata", {}).get("resourceVersion")
        if have != str(expect_rv):
            raise ApiError(
                f"{resource} {k} conflict: resourceVersion {have} != {expect_rv}",
                status=409,
            )

    def delete(
        self, resource: str, namespace: str, name: str,
        expect_rv: Optional[str] = None,
    ) -> None:
        """DELETE; ``expect_rv`` makes it a compare-and-delete so a stale
        ex-leader cannot remove a lease a standby just re-acquired."""
        k = (namespace, name)
        cur = self._store[resource].get(k)
        if cur is None:
            raise ApiError(f"{resource} {k} not found", status=404)
        self._check_rv(cur, resource, k, expect_rv)
        del self._store[resource][k]
        self._bump(resource, DELETED, cur)

    def get(self, resource: str, namespace: str, name: str) -> Optional[dict]:
        obj = self._store[resource].get((namespace, name))
        return copy.deepcopy(obj) if obj is not None else None

    def list(self, resource: str) -> Tuple[List[dict], int]:
        """LIST: (items, resourceVersion to watch from)."""
        return [copy.deepcopy(o) for o in self._store[resource].values()], self._rv

    def compact(self, upto_rv: Optional[int] = None) -> int:
        """Drop event-log entries with rv <= ``upto_rv`` (default: the
        current head — the whole log), like etcd compaction shrinking the
        apiserver's watch window.  Clients watching from below the new
        horizon get a :class:`GoneError` and must relist."""
        upto = self._rv if upto_rv is None else int(upto_rv)
        self.event_log = [e for e in self.event_log if e[0] > upto]
        self._compacted_rv = max(self._compacted_rv, upto)
        return self._compacted_rv

    def _check_window(self, since_rv: int) -> None:
        if since_rv < self._compacted_rv:
            raise GoneError(
                f"watch from resourceVersion {since_rv} is too old: "
                f"compacted up to {self._compacted_rv}; relist required"
            )

    def watch(self, resource: str, since_rv: int) -> List[Tuple[int, str, dict]]:
        """Pull the (rv, type, object) events for ``resource`` after
        ``since_rv`` — one informer pump's worth.  Raises
        :class:`GoneError` when ``since_rv`` predates compaction."""
        self._check_window(since_rv)
        return [
            (rv, etype, copy.deepcopy(obj))
            for rv, r, etype, obj in self.event_log
            if r == resource and rv > since_rv
        ]

    def watch_all(self, since_rv: int) -> List[Tuple[int, str, str, dict]]:
        """All resources' events after ``since_rv`` in global rv order — a
        single-threaded stand-in for concurrent per-resource informers that
        preserves causal order (a pod's bind never precedes its node).
        Raises :class:`GoneError` when ``since_rv`` predates compaction."""
        self._check_window(since_rv)
        return [
            (rv, r, etype, copy.deepcopy(obj))
            for rv, r, etype, obj in self.event_log
            if rv > since_rv
        ]

    # ---- actuation subresources ----

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        """POST /api/v1/namespaces/{ns}/pods/{name}/binding
        (DefaultBinder, cache.go:88-104)."""
        pod = self._store["pods"].get((namespace, name))
        if pod is None:
            raise ApiError(f"pod {namespace}/{name} not found", status=404)
        if pod.get("metadata", {}).get("uid") in self.fail_bind_uids:
            raise ApiError(f"bind {namespace}/{name} injected failure")
        if pod.get("spec", {}).get("nodeName"):
            raise ApiError(f"pod {namespace}/{name} already bound", status=409)
        pod.setdefault("spec", {})["nodeName"] = node_name
        self._bump("pods", MODIFIED, pod)
        if self.auto_run_bound_pods:
            pod.setdefault("status", {})["phase"] = "Running"
            self._bump("pods", MODIFIED, pod)

    def evict_pod(
        self, namespace: str, name: str, expect_rv: Optional[str] = None
    ) -> None:
        """DELETE pod (DefaultEvictor, cache.go:106-123).  ``expect_rv``
        makes it a compare-and-delete: an evictor deciding from a stale
        snapshot (the pod was bound/updated since) gets a 409 instead of
        silently killing a pod in a state it never observed."""
        pod = self._store["pods"].get((namespace, name))
        if pod is None:
            raise ApiError(f"pod {namespace}/{name} not found", status=404)
        if pod.get("metadata", {}).get("uid") in self.fail_delete_uids:
            raise ApiError(f"evict {namespace}/{name} injected failure")
        self.delete("pods", namespace, name, expect_rv=expect_rv)

    def update_pod_condition(self, namespace: str, name: str, condition: dict) -> None:
        """PATCH a pod status condition (StatusUpdater.UpdatePodCondition,
        cache.go:125-142): replaces the condition of the same type."""
        pod = self._store["pods"].get((namespace, name))
        if pod is None:
            raise ApiError(f"pod {namespace}/{name} not found", status=404)
        conds = pod.setdefault("status", {}).setdefault("conditions", [])
        conds[:] = [c for c in conds if c.get("type") != condition.get("type")]
        conds.append(copy.deepcopy(condition))
        self._bump("pods", MODIFIED, pod)

    def update_podgroup_status(self, namespace: str, name: str, status: dict) -> dict:
        """PUT /status on a PodGroup (StatusUpdater, cache.go:665-675)."""
        pg = self._store["podgroups"].get((namespace, name))
        if pg is None:
            raise ApiError(f"podgroup {namespace}/{name} not found", status=404)
        pg["status"] = copy.deepcopy(status)
        self._bump("podgroups", MODIFIED, pg)
        return copy.deepcopy(pg)

    # ---- recorded watch streams ----

    def dump_stream(self, path: str) -> None:
        """Serialize the full event log as JSONL for replay fixtures."""
        with open(path, "w") as f:
            for rv, resource, etype, obj in self.event_log:
                f.write(json.dumps(
                    {"rv": rv, "resource": resource, "type": etype, "object": obj}
                ) + "\n")

    @staticmethod
    def load_stream(path: str) -> List[Tuple[int, str, str, dict]]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                out.append((rec["rv"], rec["resource"], rec["type"], rec["object"]))
        return out

    @classmethod
    def from_stream(cls, events: Iterable[Tuple[int, str, str, dict]]) -> "FakeApiServer":
        """Rebuild a server whose store/log replays a recorded stream —
        truncation-tolerant: the store reflects a prefix-consistent state."""
        srv = cls()
        for rv, resource, etype, obj in events:
            k = _key(obj)
            if etype == DELETED:
                srv._store[resource].pop(k, None)
            else:
                srv._store[resource][k] = copy.deepcopy(obj)
            srv._rv = max(srv._rv, rv)
            srv.event_log.append((rv, resource, etype, copy.deepcopy(obj)))
        return srv
