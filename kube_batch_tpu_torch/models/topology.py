"""Topology model: pod/rack/torus coordinates for slice placement.

Counterpart of kube_batch_tpu/models/topology.py, carried over line for
line (numpy only).  Accelerator fleets place multi-host slices onto torus
topologies where contiguity and fragmentation — not raw capacity —
dominate placement quality.  This module is the host-side half of the
topology subsystem (doc/TOPOLOGY.md):

* **Coordinate model** — nodes advertise their position through labels
  (``topology.kube-batch.tpu/pod|rack|x|y|z``); :func:`parse_coord_labels`
  derives one node's coordinates and :class:`TopologyView` tensorizes a
  session's nodes into the int32 coordinate rows the batched kernels
  (ops/topo_solver.py) and the ``node_coords`` SolverInputs leaf carry.
  A node with malformed or missing coordinate labels degrades to
  flat-list placement (it simply never joins a slice box) — it does NOT
  fail the cycle; the chaos site ``topology.bad_coords`` injects exactly
  this degradation (doc/CHAOS.md).
* **Slice-shape grammar** — PodGroups request a slice through the
  ``kube-batch.tpu/slice-shape`` annotation (e.g. ``2x2x4``): 1-3
  positive integers, missing trailing axes default to 1.  Malformed
  shapes are counted and ignored (the job schedules flat).
* **Fragmentation accounting** — :meth:`TopologyView.frag_stats` walks
  free connected components per pool (6-neighbor torus adjacency) for
  the ``kube_batch_topo_frag_ratio{pool}`` /
  ``kube_batch_topo_largest_free_block{pool}`` SLO gauges, and
  :meth:`TopologyView.frag_bonus` is the ONE fragmentation-score
  function both the host nodeorder path (plugins/topology.py) and the
  device fold (models/tensor_snapshot.py adds it into ``sig_bonus``)
  compute — shared so the two paths cannot drift by construction.

``KUBE_BATCH_TPU_TOPOLOGY=0`` is the subsystem kill switch: every
consumer checks :func:`topology_enabled` first, and the off state is
bit-parity with a tree that never had the subsystem (pinned by
tests/test_topology.py and tests/test_torch_topology.py).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import knobs

log = logging.getLogger(__name__)

TOPOLOGY_ENV = knobs.TOPOLOGY.env
# Batched-vs-sequential control: =0 computes every box scan through the
# pure-numpy sequential oracle (bit-identical stats by the parity suite).
TOPO_BATCH_ENV = knobs.TOPO_BATCH.env
# Defrag-aware eviction: =0 degrades the no-free-box path to the
# capacity-only evictor (the A/B control `make bench-topo` contrasts).
TOPO_DEFRAG_ENV = knobs.TOPO_DEFRAG.env
# Beyond this many coordinate-labeled nodes the O(N^2) box scan is not
# dispatched and slice jobs stay pending (counted, documented).
TOPO_MAX_NODES_ENV = knobs.TOPO_MAX_NODES.env
DEFAULT_TOPO_MAX_NODES = knobs.TOPO_MAX_NODES.default

LABEL_PREFIX = "topology.kube-batch.tpu/"
POD_LABEL = LABEL_PREFIX + "pod"
RACK_LABEL = LABEL_PREFIX + "rack"
AXIS_LABELS = (LABEL_PREFIX + "x", LABEL_PREFIX + "y", LABEL_PREFIX + "z")
# Optional declared torus extents: without them a pod's dims are
# inferred from the observed coordinate maxima, which fabricates
# wraparound adjacency when an axis is only PARTIALLY registered
# (nodes cordoned / not yet watched).  Fleets should declare extents.
DIM_LABELS = (LABEL_PREFIX + "dx", LABEL_PREFIX + "dy",
              LABEL_PREFIX + "dz")

SLICE_SHAPE_ANNOTATION = "kube-batch.tpu/slice-shape"

# node_coords leaf layout (int32, -1 rows = no/invalid coordinates):
# [pod, rack, x, y, z, dimx, dimy, dimz] — dims are the owning pod's
# torus extents so the kernels stay self-contained per row.
COORD_WIDTH = 8


def topology_enabled() -> bool:
    return knobs.TOPOLOGY.enabled()


def topo_batch_enabled() -> bool:
    return knobs.TOPO_BATCH.enabled()


def topo_defrag_enabled() -> bool:
    return knobs.TOPO_DEFRAG.enabled()


def topo_max_nodes() -> int:
    return knobs.TOPO_MAX_NODES.value()


def parse_coord_labels(labels: Dict[str, str]) -> Optional[tuple]:
    """(pod, rack, x, y, z) from a node's labels, or None when the node
    carries no/malformed coordinates.  Rack is optional (defaults "0");
    pod and all three axes are required.  Negative axes are malformed —
    torus coordinates are non-negative by construction."""
    pod = labels.get(POD_LABEL)
    if not pod:
        return None
    rack = labels.get(RACK_LABEL, "0")
    axes = []
    for key in AXIS_LABELS:
        raw = labels.get(key)
        if raw is None:
            return None
        try:
            v = int(raw)
        except ValueError:
            return None
        if v < 0:
            return None
        axes.append(v)
    return (pod, rack, axes[0], axes[1], axes[2])


def parse_dim_labels(labels: Dict[str, str]) -> Optional[tuple]:
    """The node's declared torus extents (dx, dy, dz; 0 = undeclared
    axis), or None when no extent label is present.  A malformed or
    non-positive value is treated as undeclared — the axis falls back
    to the inferred coordinate maxima."""
    out = [0, 0, 0]
    declared = False
    for i, key in enumerate(DIM_LABELS):
        raw = labels.get(key)
        if raw is None:
            continue
        try:
            v = int(raw)
        except ValueError:
            continue
        if v < 1:
            continue
        out[i] = v
        declared = True
    return tuple(out) if declared else None


def parse_slice_shape(raw: Optional[str]) -> Optional[Tuple[int, int, int]]:
    """``AxBxC`` -> (A, B, C); 1-3 positive ints, missing axes = 1.
    None/empty/malformed -> None (the job schedules flat)."""
    if not raw:
        return None
    parts = str(raw).strip().lower().split("x")
    if not 1 <= len(parts) <= 3:
        return None
    dims = []
    for p in parts:
        try:
            v = int(p)
        except ValueError:
            return None
        if v < 1:
            return None
        dims.append(v)
    while len(dims) < 3:
        dims.append(1)
    return (dims[0], dims[1], dims[2])


def job_slice_shape(job) -> Optional[Tuple[int, int, int]]:
    """The job's slice-shape request, from its PodGroup annotation
    (kube-batch.tpu/slice-shape) — the conf/plugin machinery decides
    whether anything CONSUMES it (the topo-allocate action + topology
    plugin); the annotation alone changes nothing."""
    pg = getattr(job, "pod_group", None)
    if pg is None:
        return None
    raw = pg.metadata.annotations.get(SLICE_SHAPE_ANNOTATION)
    if raw is None:
        return None
    shape = parse_slice_shape(raw)
    if shape is None:
        from ..metrics import metrics
        metrics.note_topo_slice("bad_shape")
    return shape


class TopologyView:
    """One session's tensorized topology: sorted-name node order (the
    same order every tensor in the system uses), int32 coordinate rows,
    and the neighbor structure fragmentation accounting needs.

    Build with :func:`build_view`; instances are immutable after build
    (all consumers read)."""

    __slots__ = ("node_names", "coords", "valid", "n_valid", "pools",
                 "pool_of", "_index", "_neighbors")

    def __init__(self, node_names: List[str]):
        n = len(node_names)
        self.node_names = node_names
        self.coords = np.full((max(n, 1), COORD_WIDTH), -1, np.int32)
        self.valid = np.zeros((max(n, 1),), bool)
        self.n_valid = 0
        self.pools: List[str] = []          # pod index -> pod name
        self.pool_of: Dict[int, int] = {}   # node row -> pod index
        self._index: Dict[tuple, int] = {}  # (pod, x, y, z) -> node row
        self._neighbors: Optional[list] = None

    # -- neighbor / fragmentation accounting ---------------------------

    def neighbors(self) -> list:
        """Per-node list of neighbor rows under 6-neighbor torus
        adjacency (+-1 on one axis, mod the pod's dims).  Coordinate
        holes (no node at the wrapped position) are simply absent.
        Built lazily once per view."""
        if self._neighbors is not None:
            return self._neighbors
        out: list = [()] * len(self.node_names)
        c = self.coords
        for i in range(len(self.node_names)):
            if not self.valid[i]:
                continue
            pod, _rack, x, y, z, dx, dy, dz = (int(v) for v in c[i])
            found: Dict[int, None] = {}
            for axis, dim in ((0, dx), (1, dy), (2, dz)):
                if dim <= 1:
                    continue
                for step in (-1, 1):
                    p = [x, y, z]
                    p[axis] = (p[axis] + step) % dim
                    j = self._index.get((pod, p[0], p[1], p[2]))
                    if j is not None and j != i:
                        # dim-2 axes reach the same node in both wrap
                        # directions: count that neighbor once.
                        found[j] = None
            out[i] = tuple(found)
        self._neighbors = out
        return out

    def frag_bonus(self, occupied: np.ndarray, weight: int) -> np.ndarray:
        """int32 [N] fragmentation-aware score bonus: prefer placing next
        to already-occupied (or absent) torus neighbors, preserving large
        contiguous free blocks elsewhere.  Exact integers on the shared
        SCORE_GRID_K grid — the host prioritizer (plugins/topology.py)
        and the device fold (tensor_snapshot adds it into sig_bonus)
        both call THIS function, so the two paths cannot drift."""
        from ..ops.resources import SCORE_GRID_K
        n = len(self.node_names)
        bonus = np.zeros((max(n, 1),), np.int64)
        if not weight or not self.n_valid:
            return bonus.astype(np.int32)
        nbrs = self.neighbors()
        for i in range(n):
            if not self.valid[i]:
                continue
            # Missing neighbors (coordinate holes / degraded nodes) count
            # as occupied: placing against them cannot fragment anything.
            # A dim-2 axis has ONE distinct neighbor (both wrap
            # directions land on the same node), dim>2 has two.
            dims = self.coords[i, 5:8]
            max_nbrs = int((dims > 2).sum()) * 2 + int((dims == 2).sum())
            present = nbrs[i]
            occ = max_nbrs - len(present)
            for j in present:
                if occupied[j]:
                    occ += 1
            bonus[i] = occ
        return (bonus * int(weight) * SCORE_GRID_K).astype(np.int32)

    def frag_stats(self, free: np.ndarray) -> Dict[str, dict]:
        """{pool: {free, largest_block, frag_ratio}}: largest connected
        free component per pool under torus adjacency.  frag_ratio =
        1 - largest/free (0.0 when the pool has no free node — an empty
        pool is full, not fragmented)."""
        out: Dict[str, dict] = {}
        nbrs = self.neighbors()
        seen = np.zeros((len(self.node_names),), bool)
        per_pool_free: Dict[int, int] = {}
        per_pool_largest: Dict[int, int] = {}
        for i in range(len(self.node_names)):
            if not self.valid[i]:
                continue
            pool = self.pool_of[i]
            if free[i]:
                per_pool_free[pool] = per_pool_free.get(pool, 0) + 1
            if not free[i] or seen[i]:
                continue
            # BFS one free component.
            size = 0
            stack = [i]
            seen[i] = True
            while stack:
                k = stack.pop()
                size += 1
                for j in nbrs[k]:
                    if free[j] and not seen[j]:
                        seen[j] = True
                        stack.append(j)
            if size > per_pool_largest.get(pool, 0):
                per_pool_largest[pool] = size
        for pix, name in enumerate(self.pools):
            nfree = per_pool_free.get(pix, 0)
            largest = per_pool_largest.get(pix, 0)
            out[name] = {
                "free": nfree,
                "largest_block": largest,
                "frag_ratio": (round(1.0 - largest / nfree, 4)
                               if nfree else 0.0),
            }
        return out


def build_view(nodes: Dict[str, object],
               node_names: Optional[List[str]] = None) -> TopologyView:
    """Tensorize a session's nodes into a TopologyView.

    Chaos site ``topology.bad_coords`` (doc/CHAOS.md): an injected fault
    degrades THAT node to flat-list placement for this build — exactly
    the malformed-label path — instead of failing the cycle.  One
    ``PLAN is None`` branch when chaos is off."""
    from ..chaos import plan as chaos_plan
    from ..metrics import metrics

    names = node_names if node_names is not None else sorted(nodes)
    plan = chaos_plan.PLAN
    parsed: List[tuple] = []
    declared: List[tuple] = []
    for name in names:
        ninfo = nodes[name]
        node = getattr(ninfo, "node", None)
        coords = None if node is None \
            else parse_coord_labels(node.metadata.labels)
        if coords is not None and plan is not None \
                and plan.fire("topology.bad_coords"):
            # Injected label corruption: this node schedules flat this
            # session; the slice subsystem simply doesn't see it.
            metrics.note_topo_bad_coords()
            coords = None
        parsed.append(coords)
        declared.append(parse_dim_labels(node.metadata.labels)
                        if coords is not None else None)
    return view_from_parsed(list(names), parsed, declared)


def view_from_parsed(names: List[str], parsed: List[Optional[tuple]],
                     declared: Optional[List[Optional[tuple]]] = None,
                     count_bad: bool = True) -> TopologyView:
    """The interning core shared by :func:`build_view` and the tensor
    pack's ``node_coords`` leaf assembly (models/tensor_snapshot.py) —
    ONE implementation of the duplicate-degradation and dims rules, so
    the host view and the shipped leaf cannot drift.

    Duplicates: EVERY node claiming an already-claimed ``(pod, x, y,
    z)`` degrades to flat, including later claimants of a position
    already degraded (the dead-position set) — an ambiguous position
    never re-enters the torus within a build.  Dims: per-pod extents
    are the max of the declared ``dx/dy/dz`` labels and the observed
    coordinate maxima; declared extents prevent false wraparound
    adjacency on a partially-registered axis.  ``count_bad=False``
    suppresses the bad-coords counter (the leaf assembly re-runs the
    same rows every tensorize; only the session view counts)."""
    from ..metrics import metrics

    view = TopologyView(list(names))
    parsed = list(parsed)
    pods: Dict[str, int] = {}
    racks: Dict[str, int] = {}
    dims: Dict[int, list] = {}
    dead: set = set()
    for i, coords in enumerate(parsed):
        if coords is None:
            continue
        pod, rack, x, y, z = coords
        pix = pods.setdefault(pod, len(pods))
        rix = racks.setdefault(rack, len(racks))
        key = (pix, x, y, z)
        if key in dead:
            # A third (or later) claimant of an ambiguous position:
            # still ambiguous, still flat.
            if count_bad:
                metrics.note_topo_bad_coords()
            parsed[i] = None
            continue
        if key in view._index:
            # Duplicate coordinate: both nodes are degraded to flat
            # (counted) — a slice box over an ambiguous position would
            # be nondeterministic.
            if count_bad:
                metrics.note_topo_bad_coords()
            dup = view._index.pop(key)
            view.valid[dup] = False
            view.coords[dup] = -1
            view.pool_of.pop(dup, None)
            parsed[i] = None
            dead.add(key)
            continue
        view._index[key] = i
        view.coords[i, :5] = (pix, rix, x, y, z)
        view.valid[i] = True
        view.pool_of[i] = pix
        d = dims.setdefault(pix, [1, 1, 1])
        d[0] = max(d[0], x + 1)
        d[1] = max(d[1], y + 1)
        d[2] = max(d[2], z + 1)
    if declared is not None:
        for i, decl in enumerate(declared):
            if decl is None or not view.valid[i]:
                continue
            d = dims.get(int(view.coords[i, 0]))
            if d is not None:
                for a in range(3):
                    if decl[a] > d[a]:
                        d[a] = decl[a]
    view.pools = [name for name, _ in sorted(pods.items(),
                                             key=lambda kv: kv[1])]
    for i in range(len(names)):
        if view.valid[i]:
            view.coords[i, 5:8] = dims[int(view.coords[i, 0])]
    view.n_valid = int(view.valid.sum())
    return view


def coords_leaf(view: Optional[TopologyView], n_pad: int) -> np.ndarray:
    """The [n_pad, COORD_WIDTH] int32 ``node_coords`` SolverInputs leaf:
    the view's rows bucket-padded with -1 (invalid).  An all-(-1) leaf
    (topology off / no labels) is the flat-cluster encoding — the leaf
    always exists so the shipped layout never flips on the subsystem's
    gate."""
    leaf = np.full((n_pad, COORD_WIDTH), -1, np.int32)
    if view is not None and view.n_valid:
        n = min(len(view.node_names), n_pad)
        leaf[:n] = view.coords[:n]
    return leaf


class TopoTable:
    """Last-computed fragmentation table for /debug/topology (the
    tenants-table pattern): the topo action / plugin publish here, the
    HTTP endpoint snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._doc: dict = {"pools": {}, "updated": None}  # guarded-by: _lock

    def publish(self, pools: Dict[str, dict], extra: Optional[dict] = None
                ) -> None:
        import time
        with self._lock:
            self._doc = {"pools": pools, "updated": time.time()}
            if extra:
                self._doc.update(extra)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._doc)


topo_table = TopoTable()
