"""Replay a recorded lineage ring as a reproducible workload trace
(the repo's tools/replay.py, driving the port).

The lineage ring (``trace/lineage.py``) records every pod's ingest ->
considered -> placed -> bind -> echo timeline against the session-open
ledger.  That is a workload trace: which objects arrived between which
scheduling sessions, who got evicted, who was deleted externally.

* :class:`SpecArchive` wraps a truth :class:`Cluster`'s create verbs and
  archives each object's spec at creation time — eviction and churn
  delete pods from truth, so capture-time truth alone cannot rebuild the
  workload;
* :func:`capture` merges the archive with ``lineage.dump()`` and the
  truth store's final state into one self-contained JSON trace:
  inventory, per-pod specs tagged with the session seq they first
  became visible to, externally-deleted pods tagged with the session
  their delete preceded, the scheduler conf, and the recorded outcome
  (bind map + surviving/deleted pod sets);
* :func:`replay` rebuilds a fresh fake cluster from the trace and
  re-drives the exact recorded cadence on ``device`` — before session
  *s*, create the pods first visible at *s* and apply the external
  deletes that preceded *s*; run one scheduler cycle per recorded
  session; then drain to quiescence — and :func:`compare` asserts the
  replayed bind map, surviving pods, and deleted set are bit-identical to
  the recorded ones.

The trace format is the reference's (``TRACE_VERSION`` 1, the same
documents), so a trace recorded by either package replays in the other.
Bit-identity holds on the fake cluster because its informer echo is
synchronous and every scheduling decision is a deterministic function of
(object specs, arrival grouping), both of which the trace pins.

CLI::

    python -m kube_batch_tpu_torch.tools.replay TRACE.json [--device cpu]
    python -m kube_batch_tpu_torch.tools.replay --selftest [--device cpu]

The device is the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import torch

# Small shapes must still engage the device scanner + batched engines
# (set before the port's imports).
os.environ.setdefault("KUBE_BATCH_TPU_SCAN_MIN_NODES", "0")

from kube_batch_tpu_torch.cache import Cluster, new_scheduler_cache  # noqa: E402
from kube_batch_tpu_torch.api.objects import (  # noqa: E402
    Container, Node, NodeSpec, NodeStatus, ObjectMeta, Pod, PodSpec,
    PodStatus, PriorityClass)
from kube_batch_tpu_torch.apis.scheduling import v1alpha1  # noqa: E402
from kube_batch_tpu_torch.chaos.breaker import device_breaker  # noqa: E402
from kube_batch_tpu_torch.scheduler import Scheduler  # noqa: E402
from kube_batch_tpu_torch.tools import add_device_flag, cli_device  # noqa: E402
from kube_batch_tpu_torch.trace.lineage import lineage  # noqa: E402

TRACE_VERSION = 1


# ---------------------------------------------------------------------------
# object <-> doc serialization (shared with scenario_gen.py)

def pod_doc(pod: Pod) -> dict:
    c = pod.spec.containers[0] if pod.spec.containers else Container()
    return {
        "name": pod.metadata.name, "namespace": pod.metadata.namespace,
        "uid": pod.metadata.uid,
        "annotations": dict(pod.metadata.annotations),
        "labels": dict(pod.metadata.labels),
        "creation_timestamp": pod.metadata.creation_timestamp,
        "priority": pod.spec.priority,
        "priority_class_name": pod.spec.priority_class_name,
        "node_selector": dict(pod.spec.node_selector),
        "requests": {k: str(v) for k, v in c.requests.items()},
        "node_name": pod.spec.node_name,
        "phase": pod.status.phase,
    }


def build_pod(doc: dict) -> Pod:
    return Pod(
        metadata=ObjectMeta(
            name=doc["name"], namespace=doc["namespace"], uid=doc["uid"],
            annotations=dict(doc.get("annotations") or {}),
            labels=dict(doc.get("labels") or {}),
            creation_timestamp=doc.get("creation_timestamp") or 0.0),
        spec=PodSpec(
            node_name=doc.get("node_name") or "",
            node_selector=dict(doc.get("node_selector") or {}),
            priority=doc.get("priority"),
            priority_class_name=doc.get("priority_class_name") or "",
            containers=[Container(requests=dict(doc.get("requests") or {}))]),
        status=PodStatus(phase=doc.get("phase") or "Pending"))


def node_doc(node: Node) -> dict:
    return {"name": node.metadata.name, "uid": node.metadata.uid,
            "labels": dict(node.metadata.labels),
            "allocatable": {k: str(v)
                            for k, v in node.status.allocatable.items()},
            "capacity": {k: str(v)
                         for k, v in node.status.capacity.items()}}


def build_node(doc: dict) -> Node:
    return Node(
        metadata=ObjectMeta(name=doc["name"], uid=doc.get("uid") or
                            doc["name"], labels=dict(doc.get("labels") or {})),
        spec=NodeSpec(),
        status=NodeStatus(allocatable=dict(doc["allocatable"]),
                          capacity=dict(doc.get("capacity")
                                        or doc["allocatable"])))


def pg_doc(pg) -> dict:
    return {"name": pg.metadata.name, "namespace": pg.metadata.namespace,
            "annotations": dict(pg.metadata.annotations),
            "creation_timestamp": pg.metadata.creation_timestamp,
            "min_member": pg.spec.min_member, "queue": pg.spec.queue,
            "priority_class_name": pg.spec.priority_class_name}


def build_pg(doc: dict):
    return v1alpha1.PodGroup(
        metadata=ObjectMeta(
            name=doc["name"], namespace=doc["namespace"],
            annotations=dict(doc.get("annotations") or {}),
            creation_timestamp=doc.get("creation_timestamp") or 0.0),
        spec=v1alpha1.PodGroupSpec(
            min_member=doc["min_member"], queue=doc["queue"],
            priority_class_name=doc.get("priority_class_name") or ""))


def queue_doc(q) -> dict:
    return {"name": q.metadata.name, "weight": q.spec.weight,
            "creation_timestamp": q.metadata.creation_timestamp}


def build_queue(doc: dict):
    return v1alpha1.Queue(
        metadata=ObjectMeta(name=doc["name"],
                            creation_timestamp=doc.get("creation_timestamp")
                            or 0.0),
        spec=v1alpha1.QueueSpec(weight=doc.get("weight", 1)))


def pc_doc(pc: PriorityClass) -> dict:
    return {"name": pc.metadata.name, "value": pc.value}


def build_pc(doc: dict) -> PriorityClass:
    return PriorityClass(metadata=ObjectMeta(name=doc["name"]),
                         value=doc["value"])


# ---------------------------------------------------------------------------
# recording

class SpecArchive:
    """Wrap a truth :class:`Cluster`'s create verbs and archive each
    object's spec at creation time, in creation order.  Deletion removes
    objects from truth but never from the archive — the archive is what
    lets :func:`capture` rebuild pods that were evicted or churned away
    before capture ran."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.nodes: list = []
        self.queues: list = []
        self.priority_classes: list = []
        self.pod_groups: list = []
        self.pods: dict = {}  # "ns/name" -> doc, creation order
        self._wrap()

    def _wrap(self) -> None:
        c = self.cluster
        orig = {v: getattr(c, v) for v in
                ("create_pod", "create_node", "create_queue",
                 "create_pod_group", "create_priority_class")}

        def create_pod(pod):
            self.pods[f"{pod.metadata.namespace}/{pod.metadata.name}"] = \
                pod_doc(pod)
            return orig["create_pod"](pod)

        def create_node(node):
            self.nodes.append(node_doc(node))
            return orig["create_node"](node)

        def create_queue(q):
            self.queues.append(queue_doc(q))
            return orig["create_queue"](q)

        def create_pod_group(pg):
            self.pod_groups.append(pg_doc(pg))
            return orig["create_pod_group"](pg)

        def create_priority_class(pc):
            self.priority_classes.append(pc_doc(pc))
            return orig["create_priority_class"](pc)

        c.create_pod = create_pod
        c.create_node = create_node
        c.create_queue = create_queue
        c.create_pod_group = create_pod_group
        c.create_priority_class = create_priority_class


def _truth_binds(cluster: Cluster) -> dict:
    with cluster.lock:
        return {key: pod.spec.node_name
                for key, pod in cluster.pods.items() if pod.spec.node_name}


def _truth_pods(cluster: Cluster) -> set:
    with cluster.lock:
        return set(cluster.pods)


def capture(archive: SpecArchive, conf: str) -> dict:
    """One self-contained trace from (archive specs, lineage ring,
    truth final state).  Requires the lineage ring to be enabled for
    the recorded run (it supplies the arrival cadence)."""
    ring = lineage.dump()
    if not ring["enabled"]:
        raise RuntimeError("capture needs KUBE_BATCH_TPU_LINEAGE=1: the "
                           "ring is the record of the arrival cadence")
    if ring["pods_dropped"] or ring["sessions_dropped"]:
        # An overflowed ring is no longer a complete record: aged-out
        # pods would replay as wave-0 inventory and the cadence would
        # silently diverge.  Refuse loudly — size the ring to the
        # incident (KUBE_BATCH_TPU_LINEAGE_RING / _TRACE_RING) instead.
        raise RuntimeError(
            f"lineage ring overflowed during the recorded run "
            f"({ring['pods_dropped']} pods, "
            f"{ring['sessions_dropped']} ledger entries aged out): the "
            f"trace would be incomplete.  Raise KUBE_BATCH_TPU_LINEAGE_RING "
            f"past the workload's pod count and re-record")
    by_key = {p["pod"]: p for p in ring["pods"]}
    ledger = ring["ledger"]
    surviving = _truth_pods(archive.cluster)

    pods = []
    for key, doc in archive.pods.items():
        rec = by_key.get(key)
        out = dict(doc)
        # A pod the ring never tracked (created Running/bound — e.g. a
        # pre-bound filler) replays with its wave-0 inventory; a
        # tracked pod replays at its recorded session.  A tracked pod
        # ingested AFTER the last session open has no ledger entry past
        # its stamp (dump reports None) — it must land after the loop,
        # not be conflated with wave-0 inventory.
        fs = rec["first_session"] if rec else None
        if rec is not None and fs is None:
            fs = int(ring["sessions"]) + 1
        out["first_session"] = fs
        out["delete_before_session"] = None
        if key not in surviving:
            if rec is None or rec["evicted"]:
                # Organic: the replayed scheduler re-evicts it itself.
                out["external_delete"] = False
            else:
                out["external_delete"] = True
                # The delete preceded the first session opened after its
                # timestamp — replay applies it at the same boundary.
                del_ts = next((s["t"] for s in rec["stages"]
                               if s["stage"] == "deleted"), None)
                if del_ts is not None:
                    out["delete_before_session"] = next(
                        (seq for seq, ts in ledger if ts > del_ts), None)
        else:
            out["external_delete"] = False
        pods.append(out)

    return {
        "version": TRACE_VERSION,
        "conf": conf,
        "recorded_sessions": ring["sessions"],
        "inventory": {
            "nodes": archive.nodes,
            "queues": archive.queues,
            "priority_classes": archive.priority_classes,
            "pod_groups": archive.pod_groups,
        },
        "pods": pods,
        "recorded": {
            "bind_map": _truth_binds(archive.cluster),
            "surviving": sorted(surviving),
            "deleted": sorted(set(archive.pods) - surviving),
        },
    }


# ---------------------------------------------------------------------------
# replay

def replay(trace: dict, drain_cap: int = 40, *, device=None,
           dtype: torch.dtype = torch.float32) -> dict:
    """Re-drive the trace on a fresh fake cluster at the recorded
    cadence, the Scheduler's actions on ``device`` (the card unless the
    CPU is asked for) with ``dtype`` keys, and return the replayed
    outcome."""
    if trace.get("version") != TRACE_VERSION:
        raise ValueError(f"unsupported trace version "
                         f"{trace.get('version')!r}")
    cluster = Cluster()
    inv = trace["inventory"]
    for doc in inv["priority_classes"]:
        cluster.create_priority_class(build_pc(doc))
    for doc in inv["queues"]:
        cluster.create_queue(build_queue(doc))
    for doc in inv["nodes"]:
        cluster.create_node(build_node(doc))
    for doc in inv["pod_groups"]:
        cluster.create_pod_group(build_pg(doc))

    # Ops per session boundary: before session s run creates[s] +
    # deletes[s]; None means "before the first session" for creates
    # (never-ringed inventory) and "after the last" for deletes.
    creates: dict = {}
    deletes: dict = {}
    for doc in trace["pods"]:
        s = doc.get("first_session")
        creates.setdefault(1 if s is None else s, []).append(doc)
        if doc.get("external_delete"):
            deletes.setdefault(doc.get("delete_before_session"),
                               []).append(f"{doc['namespace']}/"
                                          f"{doc['name']}")

    cache = new_scheduler_cache(cluster)
    scheduler = Scheduler(cache, scheduler_conf=trace["conf"],
                          schedule_period=3600, device=device, dtype=dtype)
    device_breaker().reset()
    loop_deaths: list = []

    def one_cycle() -> None:
        try:
            scheduler.cycle()
        except Exception as exc:  # the loop-survival contract broke
            # lint: allow-swallow(recorded in loop_deaths and reported as a replay divergence — the harness outlives the cycle to diff the wreckage)
            loop_deaths.append(f"{type(exc).__name__}: {exc}")

    def apply_boundary(s) -> None:
        for doc in creates.pop(s, ()):
            cluster.create_pod(build_pod(doc))
        for key in deletes.pop(s, ()):
            ns, name = key.split("/", 1)
            try:
                cluster.delete_pod(ns, name)
            except KeyError:
                pass  # already gone (evicted first in the replay)

    for s in range(1, int(trace["recorded_sessions"]) + 1):
        apply_boundary(s)
        one_cycle()
    # Anything recorded past the last session (or with an evicted
    # ledger entry) lands now, then the replay drains to quiescence.
    for s in sorted(creates, key=lambda v: (v is None, v)):
        for doc in creates[s]:
            cluster.create_pod(build_pod(doc))
    creates.clear()
    for s in list(deletes):
        apply_boundary(s)

    stable, last = 0, (None, None)
    for _ in range(drain_cap):
        one_cycle()
        state = (_truth_binds(cluster), _truth_pods(cluster))
        stable = stable + 1 if state == last else 0
        last = state
        if stable >= 2:
            break

    all_keys = {f"{d['namespace']}/{d['name']}" for d in trace["pods"]}
    surviving = _truth_pods(cluster)
    return {"bind_map": _truth_binds(cluster),
            "surviving": sorted(surviving),
            "deleted": sorted(all_keys - surviving),
            "loop_deaths": loop_deaths,
            "quiesced": stable >= 2}


def compare(trace: dict, result: dict) -> list:
    """Bit-identity errors between the recorded outcome and a replay."""
    errs = []
    rec = trace["recorded"]
    if result["loop_deaths"]:
        errs.append(f"replay loop deaths: {result['loop_deaths']}")
    if not result["quiesced"]:
        errs.append("replay never quiesced")
    if result["bind_map"] != rec["bind_map"]:
        only_r = set(rec["bind_map"].items()) - set(
            result["bind_map"].items())
        only_p = set(result["bind_map"].items()) - set(
            rec["bind_map"].items())
        errs.append(f"bind map diverged (recorded-only="
                    f"{sorted(only_r)[:6]}, replay-only="
                    f"{sorted(only_p)[:6]})")
    if result["surviving"] != rec["surviving"]:
        errs.append("surviving pod set diverged")
    if result["deleted"] != rec["deleted"]:
        errs.append(f"deleted set diverged (recorded={rec['deleted']}, "
                    f"replay={result['deleted']})")
    return errs


# ---------------------------------------------------------------------------
# CLI

def _selftest(device) -> dict:
    """Record a small run (the scenario generator's fragmentation-
    pressure workload), capture it, replay it, compare."""
    from kube_batch_tpu_torch.tools import scenario_gen as sg
    spec = sg.gen_scenario("frag_pressure", 0)
    trace = sg.record_trace(spec, cycles_per_wave=2, device=device)
    result = replay(trace, device=device)
    return {"trace_pods": len(trace["pods"]),
            "recorded_binds": len(trace["recorded"]["bind_map"]),
            "errors": compare(trace, result)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("trace", nargs="?", help="trace JSON to replay")
    ap.add_argument("--selftest", action="store_true",
                    help="record a demo run, then round-trip it")
    ap.add_argument("--out", help="write the replayed outcome JSON here")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    device = cli_device(args, "replay")
    if device is None:
        return 1
    start = time.time()
    if args.selftest:
        res = _selftest(device)
        res["wall_s"] = round(time.time() - start, 1)
        print(json.dumps(res, sort_keys=True))
        return 1 if res["errors"] else 0
    if not args.trace:
        ap.error("need a trace file (or --selftest)")
    trace = json.loads(pathlib.Path(args.trace).read_text())
    result = replay(trace, device=device)
    errors = compare(trace, result)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"trace": args.trace,
                      "recorded_binds": len(trace["recorded"]["bind_map"]),
                      "replayed_binds": len(result["bind_map"]),
                      "errors": errors,
                      "wall_s": round(time.time() - start, 1)},
                     sort_keys=True))
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
