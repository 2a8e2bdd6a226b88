"""HTTP shim for the live plane: a localhost REST apiserver over
:class:`fakeapi.FakeApiServer` and a client speaking the same verbs (the
port's copy of kube_arbitrator_tpu/cache/httpapi.py: the same paths and
JSON, so either package's client talks to the other's server).

The reference's clientsets speak HTTPS to a live apiserver
(``pkg/scheduler/cache/cache.go:202-223`` builds kube + kb clientsets from
a rest.Config; the generated ``pkg/client/`` issues LIST/WATCH streams and
the binding/eviction/status subresource calls).  This module closes the
same seam: :func:`serve_api` exposes the six verbs of
the in-process store over HTTP with Kubernetes-shaped paths, and
:class:`HttpApiClient` implements the exact duck-typed surface
:class:`cache.live.LiveCache` consumes (``list`` / ``watch_all`` / ``get``
/ ``bind_pod`` / ``evict_pod`` / ``update_pod_condition`` /
``update_podgroup_status``), so the live plane dials a URL instead of a
Python object — stdlib only (http.server + urllib), no client libraries.

Paths (namespaced resources; cluster-scoped ones drop the namespace
segment exactly like the real apiserver):

========  =====================================================  ==========
verb      path                                                   maps to
========  =====================================================  ==========
GET       /api/v1/{resource}                                     list
GET       /api/v1/watch?since={rv}                               watch_all
GET       /api/v1/namespaces/{ns}/{resource}/{name}              get
POST      /api/v1/namespaces/{ns}/pods/{name}/binding            bind_pod
DELETE    /api/v1/namespaces/{ns}/pods/{name}                    evict_pod
PATCH     /api/v1/namespaces/{ns}/pods/{name}/condition          update_pod_condition
PUT       /apis/scheduling/v1alpha1/namespaces/{ns}/podgroups/{name}/status  update_podgroup_status
POST      /api/v1/{resource} (+ body object)                     create
PUT       /api/v1/namespaces/{ns}/{resource}/{name}              update
==========================================================================

The server serializes every store call behind one lock (the in-memory
store is not thread-safe; the real apiserver serializes per-object through
etcd's MVCC — one coarse lock is the honest single-node equivalent).
"""
from __future__ import annotations

import hmac
import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from .fakeapi import ApiError, FakeApiServer, RESOURCES, _key
from ..utils import locking


def _split(path: str) -> List[str]:
    return [p for p in path.split("/") if p]


class _Handler(BaseHTTPRequestHandler):
    # the FakeApiServer and its lock ride on the server object
    server_version = "kat-fakeapi/1.0"
    protocol_version = "HTTP/1.1"
    # Per-connection socket timeout (applied by BaseHTTPRequestHandler
    # before each request): a client that claims a Content-Length and then
    # stalls mid-send — authenticated or not — must not pin a handler
    # thread forever.  No route long-polls (watch returns buffered events
    # immediately), so a generous bound is safe.
    timeout = 30.0

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # ---- plumbing ----

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n == 0:
            return {}
        return json.loads(self.rfile.read(n))

    def _send(self, code: int, obj) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _route(self, verb: str) -> None:
        api: FakeApiServer = self.server.api  # type: ignore[attr-defined]
        lock = self.server.api_lock  # type: ignore[attr-defined]
        # Bearer-token check BEFORE any dispatch (the reference's
        # clientsets always authenticate, server.go:51-56; RBAC rides on
        # the identity).  Constant-time compare: a timing oracle on a
        # localhost seam is cheap paranoia, but it is one line.
        required: Optional[str] = getattr(self.server, "api_token", None)
        if required is not None:
            presented = self.headers.get("Authorization", "")
            # bytes compare: compare_digest raises TypeError on non-ASCII
            # str (headers decode as latin-1, so arbitrary bytes reach us)
            ok = hmac.compare_digest(
                presented.encode("latin-1", "replace"),
                f"Bearer {required}".encode(),
            )
            if not ok:
                # Drain a BOUNDED amount of the unread body so a client
                # mid-send sees the 401 instead of a connection reset
                # (EPIPE would surface as a transient network error and
                # be retried forever), then close the connection so a
                # keep-alive client cannot desync on any remainder.
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    if 0 < n <= 1 << 20:
                        self.rfile.read(n)
                except (ValueError, OSError):
                    pass
                self.close_connection = True
                self._send(401, {"kind": "Status", "status": "Failure",
                                 "reason": "Unauthorized",
                                 "message": "invalid or missing bearer token"})
                return
        url = urllib.parse.urlparse(self.path)
        parts = _split(url.path)
        query = urllib.parse.parse_qs(url.query)
        # Socket I/O stays OUTSIDE the store lock: a client that trickles
        # its body or stops reading must not stall every other caller
        # (e.g. a leader's lease renewal racing its renew deadline).
        try:
            body = self._body()
        except Exception as err:
            self._send(400, {"kind": "Status", "status": "Failure",
                             "message": f"bad body: {err}"})
            return
        try:
            with lock:
                code, payload = self._dispatch(api, verb, parts, query, body)
        except ApiError as err:
            code, payload = err.status, {
                "kind": "Status", "status": "Failure", "message": str(err)
            }
        except Exception as err:  # malformed path -> client error
            code, payload = 400, {
                "kind": "Status", "status": "Failure",
                "message": f"{type(err).__name__}: {err}",
            }
        self._send(code, payload)

    def _dispatch(self, api: FakeApiServer, verb: str, parts: List[str], query, body):
        """Returns (status_code, json payload); raises ApiError on failure."""
        # strip the API group prefix: /api/v1/... or /apis/{group}/{ver}/...
        if parts[:2] == ["api", "v1"]:
            rest = parts[2:]
        elif parts[0] == "apis" and len(parts) >= 3:
            rest = parts[3:]
        else:
            raise ApiError(f"unknown API prefix {'/'.join(parts[:2])} not found", status=404)

        if verb == "GET":
            if rest == ["watch"]:
                since = int(query.get("since", ["0"])[0])
                events = api.watch_all(since)
                return 200, {"events": [
                    {"rv": rv, "resource": r, "type": t, "object": o}
                    for rv, r, t, o in events
                ]}
            if len(rest) == 1 and rest[0] in RESOURCES:
                items, rv = api.list(rest[0])
                return 200, {"items": items, "metadata": {"resourceVersion": str(rv)}}
            ns, resource, name = self._object_ref(rest)
            obj = api.get(resource, ns, name)
            if obj is None:
                raise ApiError(f"{resource} {(ns, name)} not found", status=404)
            return 200, obj

        if verb == "POST":
            if rest[-1] == "binding":
                ns, resource, name = self._object_ref(rest[:-1])
                node = body.get("target", {}).get("name", "")
                api.bind_pod(ns, name, node)
                return 201, {"status": "Success"}
            if len(rest) == 1 and rest[0] in RESOURCES:
                return 201, api.create(rest[0], body)
            raise ApiError(f"POST {'/'.join(rest)} not found", status=404)

        if verb == "PUT":
            # subresource paths have exactly 5 segments
            # (namespaces/{ns}/podgroups/{name}/status), so an object
            # legitimately NAMED "status" can never misroute here
            if (len(rest) == 5 and rest[0] == "namespaces"
                    and rest[2] == "podgroups" and rest[4] == "status"):
                ns, resource, name = self._object_ref(rest[:-1])
                return 200, api.update_podgroup_status(ns, name, body)
            ns, resource, name = self._object_ref(rest)
            if _key(body) != (ns, name):
                # the store keys off body metadata; a silent mismatch
                # would modify a different object than the path names
                raise ApiError(
                    f"body identity {_key(body)} does not match path "
                    f"{(ns, name)}", status=400,
                )
            expect = query.get("expectResourceVersion", [None])[0]
            return 200, api.update(resource, body, expect_rv=expect)

        if verb == "PATCH":
            if (len(rest) == 5 and rest[0] == "namespaces"
                    and rest[2] == "pods" and rest[4] == "condition"):
                ns, resource, name = self._object_ref(rest[:-1])
                api.update_pod_condition(ns, name, body)
                return 200, {"status": "Success"}
            raise ApiError(f"PATCH {'/'.join(rest)} not found", status=404)

        if verb == "DELETE":
            ns, resource, name = self._object_ref(rest)
            expect = query.get("expectResourceVersion", [None])[0]
            if resource == "pods":
                # compare-and-delete precondition rides through to the
                # evictor: a stale-snapshot evict must 409, not apply
                api.evict_pod(ns, name, expect_rv=expect)
            else:
                api.delete(resource, ns, name, expect_rv=expect)
            return 200, {"status": "Success"}

        raise ApiError(f"verb {verb} not found", status=404)

    @staticmethod
    def _object_ref(rest: List[str]) -> Tuple[str, str, str]:
        """(namespace, resource, name) from a namespaced or cluster-scoped
        object path."""
        if len(rest) == 4 and rest[0] == "namespaces":
            return rest[1], rest[2], rest[3]
        if len(rest) == 2 and rest[0] in RESOURCES:
            return "", rest[0], rest[1]
        raise ApiError(f"path {'/'.join(rest)} not found", status=404)

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_PUT(self):
        self._route("PUT")

    def do_PATCH(self):
        self._route("PATCH")

    def do_DELETE(self):
        self._route("DELETE")


def serve_api(
    api: FakeApiServer, host: str = "127.0.0.1", port: int = 0,
    token: Optional[str] = None,
) -> Tuple[ThreadingHTTPServer, threading.Thread, str]:
    """Serve ``api`` over HTTP; returns (server, thread, base_url).
    ``port=0`` picks a free port.  Call ``server.shutdown()`` to stop.

    ``token`` enables bearer-token auth: every request (reads included)
    must carry ``Authorization: Bearer <token>`` or gets 401 — the seam
    analog of the reference's authenticated rest.Config
    (``app/server.go:51-56``), so the deploy artifact's RBAC story has a
    credential to hang off."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.api = api  # type: ignore[attr-defined]
    server.api_lock = locking.Lock("httpapi.api_lock")  # type: ignore[attr-defined]
    server.api_token = token  # type: ignore[attr-defined]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://{host}:{server.server_address[1]}"


class HttpApiClient:
    """The client half of the seam: same duck-typed surface as
    :class:`FakeApiServer`, speaking HTTP — hand it to
    :class:`cache.live.LiveCache` and the live plane runs over localhost
    exactly as it runs in-process (the client-go analog, cache.go:202-223)."""

    def __init__(self, base_url: str, timeout_s: float = 10.0,
                 token: Optional[str] = None,
                 token_file: Optional[str] = None):
        """``token`` (or ``token_file``, the in-cluster serviceaccount
        shape — /var/run/secrets/.../token) is sent as a bearer
        credential on every call when the server requires one."""
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        if token is None and token_file is not None:
            with open(token_file) as f:
                token = f.read().strip()
        self.token = token

    # ---- plumbing ----

    def _call(self, verb: str, path: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        if self.token is not None:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            self.base_url + path, data=data, method=verb, headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as err:
            try:
                message = json.loads(err.read()).get("message", str(err))
            except Exception:
                message = str(err)
            raise ApiError(message, status=err.code) from None
        except urllib.error.URLError as err:
            # 503 Service Unavailable: transient by contract — electors
            # retry, actuation diverts to the errTasks resync FIFO
            raise ApiError(f"apiserver unreachable: {err}", status=503) from None

    @staticmethod
    def _object_path(resource: str, namespace: str, name: str) -> str:
        if namespace:
            return f"/api/v1/namespaces/{namespace}/{resource}/{name}"
        return f"/api/v1/{resource}/{name}"

    # ---- the FakeApiServer surface ----

    def list(self, resource: str):
        out = self._call("GET", f"/api/v1/{resource}")
        return out["items"], int(out["metadata"]["resourceVersion"])

    def watch_all(self, since_rv: int):
        out = self._call("GET", f"/api/v1/watch?since={since_rv}")
        return [(e["rv"], e["resource"], e["type"], e["object"]) for e in out["events"]]

    def watch(self, resource: str, since_rv: int):
        return [
            (rv, t, o) for rv, r, t, o in self.watch_all(since_rv) if r == resource
        ]

    def get(self, resource: str, namespace: str, name: str) -> Optional[dict]:
        try:
            return self._call("GET", self._object_path(resource, namespace, name))
        except ApiError as err:
            if err.status == 404:  # NotFound -> absent, like client-go
                return None
            raise

    def create(self, resource: str, obj: dict) -> dict:
        return self._call("POST", f"/api/v1/{resource}", obj)

    def update(self, resource: str, obj: dict, expect_rv: Optional[str] = None) -> dict:
        md = obj.get("metadata", {})
        path = self._object_path(resource, md.get("namespace", ""), md["name"])
        if expect_rv is not None:
            path += f"?expectResourceVersion={expect_rv}"
        return self._call("PUT", path, obj)

    def delete(
        self, resource: str, namespace: str, name: str,
        expect_rv: Optional[str] = None,
    ) -> None:
        path = self._object_path(resource, namespace, name)
        if expect_rv is not None:
            path += f"?expectResourceVersion={expect_rv}"
        self._call("DELETE", path)

    def bind_pod(self, namespace: str, name: str, node_name: str) -> None:
        self._call(
            "POST",
            f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
            {"target": {"kind": "Node", "name": node_name}},
        )

    def evict_pod(
        self, namespace: str, name: str, expect_rv: Optional[str] = None
    ) -> None:
        path = f"/api/v1/namespaces/{namespace}/pods/{name}"
        if expect_rv is not None:
            path += f"?expectResourceVersion={expect_rv}"
        self._call("DELETE", path)

    def update_pod_condition(self, namespace: str, name: str, condition: dict) -> None:
        self._call(
            "PATCH", f"/api/v1/namespaces/{namespace}/pods/{name}/condition", condition
        )

    def update_podgroup_status(self, namespace: str, name: str, status: dict) -> dict:
        return self._call(
            "PUT",
            f"/apis/scheduling/v1alpha1/namespaces/{namespace}/podgroups/{name}/status",
            status,
        )
