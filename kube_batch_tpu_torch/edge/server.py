"""REST API server: the Cluster store over HTTP with list+watch.

The standalone analog of the Kubernetes API server surface the reference
consumes (SURVEY.md §2.2): LIST (GET), CREATE (POST), UPDATE (PUT),
DELETE, the pod ``bind`` and PodGroup ``status`` subresources
(cache.go:119-131, :763-775), and WATCH — a chunked stream of JSON-line
events ``{"type": ADDED|MODIFIED|DELETED|SYNC, "object": ...}`` where the
stream opens with ADDED events for current state and a SYNC marker (the
list+watch contract client-go's reflector relies on).

Run standalone:  python -m kube_batch_tpu_torch.edge.server --port 8090 \
                     [--cluster-state example/job.json]
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..cache.cluster import Cluster
from . import codec, codec_k8s, selectors

_RESOURCES = ("pods", "nodes", "podgroups", "queues", "priorityclasses",
              "pdbs", "pvcs", "events", "leases")

# Kubernetes-convention paths (/api/v1/..., /apis/{group}/{version}/...)
# map onto the same stores; responses/bodies on these paths use the k8s
# wire codec (camelCase, kind/apiVersion — edge/codec_k8s.py).
_K8S_RESOURCES = {
    "pods": "pods", "nodes": "nodes", "events": "events",
    "persistentvolumeclaims": "pvcs", "priorityclasses": "priorityclasses",
    "poddisruptionbudgets": "pdbs", "podgroups": "podgroups",
    "queues": "queues",
}


def _merge_patch(target, patch):
    """RFC 7386 JSON merge-patch: dicts merge recursively, ``null``
    deletes a key, everything else (including lists) replaces."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for key, value in patch.items():
        if value is None:
            out.pop(key, None)
        else:
            out[key] = _merge_patch(out.get(key), value)
    return out


# Strategic-merge list keys — the subset real apiservers declare via
# ``patchMergeKey``: these object lists merge by key; other lists
# replace, as in RFC 7386.
_MERGE_KEYS = {("status", "conditions"): "type"}

# Idle-watch keep-alive cadence.  Also the upper bound on how long a
# shard-scoped reflector can sit on a STALE selector after a lease
# claim/shed (the client checks its scope epoch per frame, PINGs
# included — doc/INGEST.md "Handover relist").  Module-level so tests
# can shrink the rescope latency.
_PING_INTERVAL_S = 5.0


def _strategic_merge(target, patch, path=()):
    """Kubernetes strategic merge patch (the fragment the edge needs):
    like merge-patch, but lists registered in _MERGE_KEYS upsert items
    by their merge key instead of replacing the whole list — so a
    writer can update ITS condition without clobbering concurrent
    writers' conditions (no read-modify-write race)."""
    if isinstance(patch, list):
        key = _MERGE_KEYS.get(path)
        if (key and isinstance(target, list)
                and all(isinstance(x, dict) for x in patch)):
            out = list(target)
            index = {x.get(key): i for i, x in enumerate(out)
                     if isinstance(x, dict)}
            for item in patch:
                i = index.get(item.get(key))
                if i is None:
                    out.append(item)
                else:
                    out[i] = _strategic_merge(out[i], item, path)
            return out
        return patch
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for key, value in patch.items():
        if value is None:
            out.pop(key, None)
        else:
            out[key] = _strategic_merge(out.get(key), value,
                                        path + (key,))
    return out


def _store_of(cluster: Cluster, resource: str):
    return {"pods": cluster.pods, "nodes": cluster.nodes,
            "podgroups": cluster.pod_groups, "queues": cluster.queues,
            "priorityclasses": cluster.priority_classes,
            "pdbs": cluster.pdbs, "pvcs": cluster.pvcs,
            "events": cluster.events}[resource]


def _informer_of(cluster: Cluster, resource: str):
    return {"pods": cluster.pod_informer, "nodes": cluster.node_informer,
            "podgroups": cluster.pod_group_informer,
            "queues": cluster.queue_informer,
            "priorityclasses": cluster.priority_class_informer,
            "pdbs": cluster.pdb_informer}.get(resource)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Keep-alive + small unbuffered writes (wbufsize=0) otherwise hit
    # Nagle/delayed-ACK stalls: a response written as status + headers +
    # body segments can wait ~40 ms per round for the peer's delayed ACK,
    # turning a bulk bind egress into minutes (measured 4 ms/bind ->
    # sub-ms with NODELAY on the loopback edge).
    disable_nagle_algorithm = True
    cluster: Cluster = None  # set by ApiServer subclassing
    history = None           # _EventHistory, set by ApiServer subclassing

    def log_message(self, *args):  # quiet; the scheduler has its own logs
        pass

    # -- helpers -----------------------------------------------------------

    def _json(self, status: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length)) if length else None

    def _route(self):
        """(resource, rest, query, k8s, ns).  Native paths are
        /v1/{resource}/...; Kubernetes-convention paths are
        /api/v1/[namespaces/{ns}/]{resource}/... and
        /apis/{group}/{version}/[namespaces/{ns}/]{resource}/... —
        the latter select the k8s wire codec for bodies and responses."""
        parsed = urlparse(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        query = parse_qs(parsed.query)
        if len(parts) >= 2 and parts[0] == "v1" and parts[1] in _RESOURCES:
            return parts[1], parts[2:], query, False, None
        if parts and parts[0] in ("api", "apis"):
            skip = 2 if parts[0] == "api" else 3
            tail = parts[skip:]
            ns = None
            if len(tail) >= 2 and tail[0] == "namespaces":
                ns, tail = tail[1], tail[2:]
            if tail:
                resource = _K8S_RESOURCES.get(tail[0])
                if resource is not None:
                    rest = tail[1:]
                    if ns is not None and rest:
                        # Internal convention is namespace-first; a bare
                        # namespaced collection path (create/list) keeps
                        # rest empty, with ns carried separately.
                        rest = [ns] + rest
                    return resource, rest, query, True, ns
        return None, None, None, False, None

    # -- verbs -------------------------------------------------------------

    def do_GET(self):
        resource, rest, query, k8s, ns = self._route()
        if resource is None:
            return self._json(404, {"error": "not found"})
        if resource == "leases":
            if len(rest) != 2:
                return self._json(404, {"error": "lease key required"})
            version, record = self.cluster.get_lease(rest[0], rest[1])
            return self._json(200, {"version": version, "record": record})
        try:  # server-side filtering (kubectl -l / --field-selector)
            match = selectors.compile_query(resource, query)
        except ValueError as exc:
            return self._json(400, {"error": str(exc)})
        if query.get("watch"):
            since = None
            if query.get("resourceVersion"):
                try:
                    since = int(query["resourceVersion"][0])
                except ValueError:
                    return self._json(400,
                                      {"error": "bad resourceVersion"})
            return self._watch(resource, k8s, ns, since, match)
        enc = codec_k8s.to_k8s if k8s else codec.encode
        single = None
        try:
            with self.cluster.lock:  # encode under the lock, send outside
                store = _store_of(self.cluster, resource)
                if rest:  # single-object GET
                    obj = (store.get("/".join(rest))
                           if hasattr(store, "get") else None)
                    if obj is not None:
                        single = enc(obj)
                else:
                    items = [enc(o) for o in store.values()
                             if (ns is None or o.metadata.namespace == ns)
                             and (match is None or match(o))]
        except ValueError as exc:  # unsupported fieldSelector path
            return self._json(400, {"error": str(exc)})
        if rest:
            if single is None:
                return self._json(404, {"error": "not found"})
            return self._json(200, single)
        if k8s:
            return self._json(200, {"apiVersion": "v1", "kind": "List",
                                    "items": items})
        self._json(200, {"items": items})

    def do_POST(self):
        resource, rest, _query, k8s, _ns = self._route()
        if resource is None:
            return self._json(404, {"error": "not found"})
        if (resource in ("pods", "pvcs") and len(rest) == 3
                and rest[2] in ("bind", "binding")):
            try:  # malformed body -> 400, distinct from store conflicts
                body = self._body()
                if rest[2] == "binding":  # k8s Binding subresource shape
                    target = (body.get("target") or {})["name"]
                else:
                    target = body["node" if resource == "pods"
                                  else "volume"]
            except (KeyError, ValueError, TypeError) as exc:
                return self._json(400, {"error": f"bad bind body: {exc}"})
            try:
                if resource == "pods":
                    self.cluster.bind_pod(rest[0], rest[1], target)
                else:
                    self.cluster.bind_pvc(rest[0], rest[1], target)
            except (KeyError, ValueError) as exc:
                return self._json(409, {"error": str(exc)})
            return self._json(200, {"status": "bound"})
        if rest:  # create routes take no path suffix
            return self._json(404, {"error": "not found"})
        if resource == "leases":  # leases are PUT-CAS only
            return self._json(405, {"error": "create not supported"})
        try:
            raw = self._body()
            if k8s and _ns is not None and isinstance(raw, dict):
                # kubectl convention: the path supplies the namespace when
                # the manifest omits it.
                raw.setdefault("metadata", {}).setdefault("namespace", _ns)
            obj = codec_k8s.decode_any(raw)
        except (ValueError, KeyError, TypeError) as exc:
            return self._json(400, {"error": str(exc)})
        create = {"pods": self.cluster.create_pod,
                  "nodes": self.cluster.create_node,
                  "podgroups": self.cluster.create_pod_group,
                  "queues": self.cluster.create_queue,
                  "priorityclasses": self.cluster.create_priority_class,
                  "pdbs": self.cluster.create_pdb,
                  "pvcs": self.cluster.create_pvc,
                  "events": self.cluster.create_event}[resource]
        try:
            create(obj)
        except (KeyError, ValueError) as exc:  # store conflict
            return self._json(409, {"error": str(exc)})
        return self._json(201, {"status": "created"})

    def do_PUT(self):
        resource, rest, _query, k8s, _ns = self._route()
        if resource is None:
            return self._json(404, {"error": "not found"})
        try:
            if resource == "leases":
                if len(rest) != 2:
                    return self._json(404, {"error": "lease key required"})
                try:
                    body = self._body()
                    record = body["record"]
                    expected = int(body["expectedVersion"])
                except (KeyError, TypeError, ValueError) as exc:
                    return self._json(400, {"error": f"bad lease body: {exc}"})
                try:
                    version = self.cluster.cas_lease(rest[0], rest[1],
                                                     record, expected)
                except ValueError as exc:  # version conflict
                    return self._json(409, {"error": str(exc)})
                return self._json(200, {"version": version})
            raw = self._body()
            if k8s and _ns is not None and isinstance(raw, dict):
                raw.setdefault("metadata", {}).setdefault("namespace", _ns)
            obj = codec_k8s.decode_any(raw)
            if resource == "podgroups" and rest and rest[-1] == "status":
                self.cluster.put_pod_group_status(obj)
                return self._json(200, {"status": "updated"})
            if (resource == "pods" and len(rest) == 3
                    and rest[2] == "status"):
                # Pod status subresource: a PodCondition upsert (native)
                # or a full k8s Pod whose entire status — phase AND
                # conditions — replaces the stored one, like a real
                # apiserver UpdateStatus (cache.go:548-568 writes
                # conditions; kubelets write phase through this path).
                from ..api.objects import Pod
                if isinstance(obj, Pod):
                    self.cluster.put_pod_status(rest[0], rest[1],
                                                obj.status)
                else:
                    self.cluster.update_pod_condition(rest[0], rest[1],
                                                      obj)
                return self._json(200, {"status": "updated"})
            update = {"pods": self.cluster.update_pod,
                      "nodes": self.cluster.update_node,
                      "podgroups": self.cluster.update_pod_group}.get(resource)
            if update is None:
                return self._json(405, {"error": "update not supported"})
            update(obj)
            return self._json(200, {"status": "updated"})
        except KeyError as exc:
            return self._json(404, {"error": str(exc)})
        except (ValueError, TypeError) as exc:  # malformed/missing body
            return self._json(400, {"error": str(exc)})

    def do_PATCH(self):
        """Merge-patch (``kubectl patch --type=merge``, RFC 7386) and
        strategic-merge-patch (conditions merged by ``type``).
        Supported on pods, podgroups (object + ``status`` subresource)
        and nodes: the stored object is encoded in the path's wire
        codec, deep-merged with the patch (null deletes a key), decoded,
        and applied through the same update/status paths as PUT."""
        resource, rest, _query, k8s, _ns = self._route()
        if resource is None or not rest:
            return self._json(404, {"error": "not found"})
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        if ctype not in ("application/merge-patch+json",
                        "application/strategic-merge-patch+json",
                        "application/json", ""):
            return self._json(415, {"error": f"unsupported patch type "
                                             f"{ctype}"})
        merge = (_strategic_merge
                 if ctype == "application/strategic-merge-patch+json"
                 else _merge_patch)
        try:
            patch = self._body()
        except ValueError as exc:
            return self._json(400, {"error": str(exc)})
        if not isinstance(patch, dict):
            return self._json(400, {"error": "patch body must be an "
                                             "object"})
        if resource not in ("pods", "podgroups", "nodes"):
            return self._json(405, {"error": "patch not supported"})
        # Same shape guard as do_PUT (len == 3): a pod legitimately
        # NAMED "status" (rest == [ns, "status"]) is an object patch.
        status_sub = len(rest) == 3 and rest[-1] == "status"
        key_parts = rest[:-1] if status_sub else rest
        enc = codec_k8s.to_k8s if k8s else codec.encode
        try:
            with self.cluster.lock:  # mutate under the lock, send outside
                store = _store_of(self.cluster, resource)
                current = (store.get("/".join(key_parts))
                           if hasattr(store, "get") else None)
                if current is not None:
                    doc = merge(enc(current), patch)
                    obj = (codec_k8s.from_k8s(doc) if k8s
                           else codec.decode(doc))
                    if resource == "pods":
                        if status_sub:
                            self.cluster.put_pod_status(key_parts[0],
                                                        key_parts[1],
                                                        obj.status)
                        else:
                            self.cluster.update_pod(obj)
                    elif resource == "podgroups":
                        if status_sub:
                            self.cluster.put_pod_group_status(obj)
                        else:
                            self.cluster.update_pod_group(obj)
                    else:
                        self.cluster.update_node(obj)
            if current is None:
                return self._json(404, {"error": "not found"})
            return self._json(200, {"status": "patched"})
        except KeyError as exc:
            return self._json(404, {"error": str(exc)})
        except (ValueError, TypeError) as exc:
            return self._json(400, {"error": str(exc)})

    def do_DELETE(self):
        resource, rest, _query, _k8s, _ns = self._route()
        if resource is None or not rest:
            return self._json(404, {"error": "not found"})
        try:
            if resource == "pods":
                self.cluster.delete_pod(rest[0], rest[1])
            elif resource == "nodes":
                self.cluster.delete_node(rest[0])
            elif resource == "podgroups":
                self.cluster.delete_pod_group(rest[0], rest[1])
            elif resource == "queues":
                self.cluster.delete_queue(rest[0])
            elif resource == "pdbs":
                self.cluster.delete_pdb(rest[0], rest[1])
            else:
                return self._json(405, {"error": "delete not supported"})
            return self._json(200, {"status": "deleted"})
        except KeyError as exc:
            return self._json(404, {"error": str(exc)})

    # -- watch -------------------------------------------------------------

    def _watch(self, resource: str, k8s: bool = False,
               ns: "str | None" = None, since: "int | None" = None,
               match=None) -> None:
        informer = _informer_of(self.cluster, resource)
        if informer is None:
            return self._json(405, {"error": f"{resource} not watchable"})
        enc = codec_k8s.to_k8s if k8s else codec.encode
        history = self.history

        def in_scope(obj) -> bool:
            # Namespaced watch paths and selectors scope server-side,
            # matching the corresponding LIST (k8s list+watch contract).
            # Selectors are validated at compile time (do_GET), so
            # match() cannot raise here.
            if ns is not None and obj.metadata.namespace != ns:
                return False
            return match is None or match(obj)

        def last_rv() -> "int | None":
            # The per-connection handler runs right after the history
            # handler (registered first, same cluster lock), so the
            # buffer tail IS this event's rv.
            if history is None:
                return None
            buf = history.buffers.get(resource)
            return buf[-1][0] if buf else None

        events: "queue.Queue" = queue.Queue()
        handle = None
        initial: list = []
        list_rv = None
        # Register BEFORE snapshotting, under the store lock, so no event
        # can fall between the initial list and the live stream.
        with self.cluster.lock:
            def on_update(old, new):
                # Selector boundary transitions surface as ADDED/DELETED,
                # the way real apiserver filtered watches behave.
                was, now = in_scope(old), in_scope(new)
                if was and now:
                    events.put(("MODIFIED", new, last_rv()))
                elif now:
                    events.put(("ADDED", new, last_rv()))
                elif was:
                    events.put(("DELETED", new, last_rv()))

            handle = informer.add_handlers(
                on_add=lambda o: in_scope(o)
                and events.put(("ADDED", o, last_rv())),
                on_update=on_update,
                on_delete=lambda o: in_scope(o)
                and events.put(("DELETED", o, last_rv())))
            pending = (history.since(resource, since)
                       if since is not None and history is not None
                       else None)
            resumed = since is not None and pending is not None
            gone = since is not None and history is not None \
                and pending is None
            if not resumed and not gone:  # the 410 path needs no snapshot
                initial = [o for o in
                           _store_of(self.cluster, resource).values()
                           if in_scope(o)]
                list_rv = (history.current_rv()
                           if history is not None else None)

        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def emit(etype, obj, rv=None, raw=None):
            frame = {"type": etype,
                     "object": (raw if raw is not None
                                else enc(obj) if obj is not None else None)}
            if rv is not None:
                frame["rv"] = rv
            line = json.dumps(frame).encode() + b"\n"
            self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
            self.wfile.flush()

        try:
            if gone:
                # The client fell past the event buffer: k8s 410 Gone
                # semantics — relist (reconnect without resourceVersion).
                emit("ERROR", None, raw={"kind": "Status", "code": 410,
                                         "reason": "Expired"})
                return
            if resumed:
                # Delta resume: no ADDED replay, no SYNC reconciliation.
                # MODIFIED history carries the pre-update object so the
                # selector boundary-transition rewrite (ADDED/DELETED)
                # applies to replayed events exactly as to live ones —
                # a filtered client must not miss an object's exit.
                emit("RESUMED", None)
                for rv, etype, obj, old in pending:
                    if etype == "MODIFIED":
                        was = in_scope(old) if old is not None else True
                        now = in_scope(obj)
                        if was and now:
                            emit("MODIFIED", obj, rv)
                        elif now:
                            emit("ADDED", obj, rv)
                        elif was:
                            emit("DELETED", obj, rv)
                    elif in_scope(obj):
                        emit(etype, obj, rv)
            else:
                for obj in initial:
                    emit("ADDED", obj)
                emit("SYNC", None, rv=list_rv)
            while True:
                try:
                    etype, obj, rv = events.get(timeout=_PING_INTERVAL_S)
                except queue.Empty:
                    emit("PING", None)  # keep-alive; detects dead peers
                    continue
                emit(etype, obj, rv)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            informer.remove_handlers(handle)


class _EventHistory:
    """Per-resource ring buffer of (rv, type, object) change events, the
    backing store for resourceVersion watch resume (k8s list+watch
    contract: a reconnecting client replays only the delta, or gets 410
    Gone and relists when it has fallen past the buffer)."""

    def __init__(self, cluster: Cluster, maxlen: int = 8192):
        from collections import deque
        self.cluster = cluster
        self.maxlen = maxlen
        self.buffers: dict = {}
        # Watermark: the highest rv NOT covered by a resource's buffer —
        # events at or below it were never recorded (before this history
        # existed, e.g. a server restart) or have been evicted.  A client
        # may resume iff its rv >= watermark.
        self.start_rv = next(cluster._rv)
        self.watermark: dict = {}
        self._registrations: list = []
        for resource in _RESOURCES:
            informer = _informer_of(cluster, resource)
            if informer is None:
                continue
            buf = deque(maxlen=maxlen)
            self.buffers[resource] = buf
            self.watermark[resource] = self.start_rv

            def _rec(buf, resource):  # bind per resource
                def record(etype):
                    def fire(*args):
                        if len(buf) == self.maxlen:  # about to evict
                            self.watermark[resource] = buf[0][0]
                        # MODIFIED keeps the pre-update object too, so
                        # resumed filtered watches can detect selector
                        # boundary transitions.
                        old = args[0] if etype == "MODIFIED" else None
                        buf.append((next(cluster._rv), etype, args[-1],
                                    old))
                    return fire
                return (record("ADDED"), record("MODIFIED"),
                        record("DELETED"))

            on_add, on_update, on_delete = _rec(buf, resource)
            handle = informer.add_handlers(on_add=on_add,
                                           on_update=on_update,
                                           on_delete=on_delete)
            self._registrations.append((informer, handle))

    def close(self) -> None:
        """Unregister from the cluster's informers (a stopped server must
        not keep recording — or pinning objects — for the cluster's
        lifetime)."""
        for informer, handle in self._registrations:
            informer.remove_handlers(handle)
        self._registrations.clear()

    def current_rv(self) -> int:
        """The rv a fresh LIST/replay corresponds to: everything up to
        the newest recorded event (or history birth when quiet)."""
        return max((buf[-1][0] for buf in self.buffers.values() if buf),
                   default=self.start_rv)

    def since(self, resource: str, rv: int):
        """Events with rv > given, or None when continuity can't be
        proven (client must relist — 410 Gone).  A client of a PREVIOUS
        server instance resumes with an rv below this history's
        watermark and correctly falls into the relist path."""
        buf = self.buffers.get(resource)
        if buf is None or rv < self.watermark.get(resource, 0):
            return None
        return [e for e in buf if e[0] > rv]


class ApiServer:
    """Serve a Cluster store over HTTP (threaded; one thread per watch)."""

    def __init__(self, cluster: Cluster, host: str = "127.0.0.1",
                 port: int = 0):
        self.cluster = cluster
        with cluster.lock:
            self._history = _EventHistory(cluster)
        handler = type("BoundHandler", (_Handler,),
                       {"cluster": cluster, "history": self._history})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ApiServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._history.close()
        self._httpd.shutdown()
        self._httpd.server_close()


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="kube-batch-tpu API server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument("--cluster-state", default="",
                        help="JSON state file to preload (cli/server.py)")
    ns = parser.parse_args(argv)
    cluster = Cluster()
    if ns.cluster_state:
        from ..cli.server import load_cluster_state
        load_cluster_state(cluster, ns.cluster_state)
    server = ApiServer(cluster, ns.host, ns.port)
    print(f"kube-batch-tpu apiserver listening on {server.url}")
    server._httpd.serve_forever()


if __name__ == "__main__":
    main()
