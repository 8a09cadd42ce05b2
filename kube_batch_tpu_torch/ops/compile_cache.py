"""Compile-ahead subsystem: the bucket ladder, boot warmup and K1's build
cache (kube_batch_tpu/ops/compile_cache.py).

The reference keeps the solver family's first-call XLA compiles out of
the session loop.  On the card there is no XLA compile; what the first
live session pays instead is the build of K1's library (``nvcc``, once
per source and flags, ``ops/cuda_solver.build_kernel``), the library's
first load, the card's cluster-capacity query for the launch plan, the
caching allocator's first growth at the bucket's size, the pinned
readback buffers and the first use of each PyTorch op.  This module
moves that work to boot:

1. **Bucket ladder** (``bucket`` / ``bucket_shapes``): the padded-shape
   ladder every tensorized axis rounds up to (models/tensor_snapshot.py
   pads with it), identical to the reference's.
2. **Startup warmup** (``SolverWarmup`` / ``warm_bucket``): at server
   boot (cli/server.py ``--warmup-buckets``), zero-valued inputs at the
   configured buckets are shipped through a ``DeviceResidentShipper`` as
   a live session ships, and every member of the family on one device
   runs once on them in a background thread: K1 on the full node axis
   (``cuda``, or its plain version ``torch`` on the CPU), K1 on gathered
   candidate rows, the batched eviction scan, the box scan (topology on)
   and the fused program (``FUSED`` on).  All queues are absent, so K1
   returns at once.  The thread sets its CUDA device and launches on
   that thread's current stream, the default stream the scheduler's
   global sessions use, so the caching allocator's pool for that stream
   is grown.  A shard view's sessions run on a stream of their own
   (tenancy/view.py) and are not warmed by this.
3. **Persistence** (``enable_persistent_cache``): the directory where
   ``build_kernel`` looks for K1's library and builds it, so a boot after
   the first loads it without ``nvcc``.  A manifest keyed by the torch
   and CUDA versions, the device, the kernel's tag and the port's version
   records what was warmed.
4. **Observability**: every routed solve is keyed (``solve_key``) and
   counted as a compile-cache hit or miss
   (``kube_batch_compile_cache_{hits,misses}_total``), the warmup exposes
   an inflight gauge, and tensorize reports per-axis bucket pad waste.

The keys are the reference's.  A JAX executable is specialised on the
static ``SolverConfig``, so the reference's key carries ``cfg``; K1
takes the conf as launch arguments (``cuda_solver.SolveArgs``) and one
library serves every conf, but the key keeps ``cfg`` all the same, so
the hit and miss counters mean the same thing in both packages.  As
in the reference, a live solve that races the warmup of its signature
is counted as a miss; on the card it then waits for the warmup's build
of K1 at ``build_kernel``'s lock, not here.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Iterable, List, NamedTuple, Optional, Sequence

log = logging.getLogger(__name__)

# NOTE: no torch / numpy / models imports at module level — this module
# is imported from the solver chokepoint and from tensor_snapshot, and
# must stay cycle-free and cheap to import.


# ---------------------------------------------------------------------------
# 1. Bucket ladder
# ---------------------------------------------------------------------------

def bucket(n: int, minimum: int = 8) -> int:
    """Next padded-shape bucket.

    Powers of two up to 1024; quarter steps within each octave above
    (1.0/1.25/1.5/1.75 x 2^k).  Every bucket above 1024 is a multiple of
    256."""
    b = minimum
    while b < n:
        b *= 2
    if b <= 1024:
        return b
    half = b // 2
    for frac in (1.25, 1.5, 1.75):
        cand = int(half * frac)
        if n <= cand:
            return cand
    return b


class BucketSpec(NamedTuple):
    """Requested (unbucketed) axis sizes of one warmup target."""
    tasks: int
    nodes: int
    jobs: int
    queues: int

    def padded(self) -> "BucketSpec":
        return BucketSpec(bucket(max(self.tasks, 1)),
                          bucket(max(self.nodes, 1)),
                          bucket(max(self.jobs, 1)),
                          bucket(max(self.queues, 1)))


def bucket_shapes(tasks: int, nodes: int, jobs: int,
                  queues: int) -> BucketSpec:
    """The padded bucket every tensorized session of these sizes lands on."""
    return BucketSpec(tasks, nodes, jobs, queues).padded()


def parse_warmup_buckets(spec: str) -> List[BucketSpec]:
    """Parse the ``--warmup-buckets`` flag: comma/semicolon-separated
    ``TASKSxNODES[xJOBS[xQUEUES]]`` entries (e.g. ``50000x10000x2000x4``).
    Omitted jobs default to tasks/25 (the bench-scale task:job ratio);
    omitted queues default to 4.  Malformed entries raise ValueError at
    config time — a bad flag must fail boot, not the first session."""
    out: List[BucketSpec] = []
    for entry in spec.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.lower().split("x")
        if len(parts) < 2 or len(parts) > 4:
            raise ValueError(
                f"warmup bucket {entry!r}: want TASKSxNODES[xJOBS[xQUEUES]]")
        try:
            nums = [int(p) for p in parts]
        except ValueError as exc:
            raise ValueError(f"warmup bucket {entry!r}: {exc}") from None
        if any(v <= 0 for v in nums):
            raise ValueError(f"warmup bucket {entry!r}: sizes must be > 0")
        tasks, nodes = nums[0], nums[1]
        jobs = nums[2] if len(nums) > 2 else max(1, tasks // 25)
        queues = nums[3] if len(nums) > 3 else 4
        out.append(BucketSpec(tasks, nodes, jobs, queues))
    return out


# ---------------------------------------------------------------------------
# 3. K1's build directory + manifest
# ---------------------------------------------------------------------------

_MANIFEST_NAME = "kube_batch_tpu_torch_warmup_manifest.json"
_cache_dir: Optional[str] = None   # guarded-by: _cache_lock
_cache_lock = threading.Lock()


def persistent_cache_dir() -> Optional[str]:
    return _cache_dir


def enable_persistent_cache(cache_dir: str) -> Optional[str]:
    """Make ``cache_dir`` the directory where ``build_kernel`` looks for
    K1's library and builds it (``cuda_solver.set_build_dir``), so a
    build survives process restarts and leader failover.  Must run before
    the first build to cover it: a library this process already loaded
    stays loaded and is copied into ``cache_dir`` (logged) for the next
    boot.  Returns the directory."""
    global _cache_dir
    from .cuda_solver import set_build_dir

    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    set_build_dir(cache_dir)
    with _cache_lock:
        _cache_dir = cache_dir
    return cache_dir


def _version_key() -> dict:
    """The library's identity: a manifest entry is only trustworthy for
    the exact (torch, CUDA, device, kernel source and flags, port
    version) that produced it, so a mismatched manifest is reset."""
    import torch

    from ..version import __version__
    from .cuda_solver import kernel_tag
    device = "cpu"
    try:
        if torch.cuda.is_available():
            idx = torch.cuda.current_device()
            major, minor = torch.cuda.get_device_capability(idx)
            device = (f"{torch.cuda.get_device_name(idx)} "
                      f"sm_{major}{minor}")
    except Exception:  # lint: allow-swallow(device probe at manifest-read time; "unknown" just voids manifest trust)
        device = "unknown"
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": device, "kernel": kernel_tag(),
            "kube_batch_tpu_torch": __version__}


def _manifest_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, _MANIFEST_NAME)


def read_manifest(cache_dir: str) -> dict:
    """The warmup manifest for this version key, or an empty one (missing
    file, unreadable file, or a version mismatch all reset it)."""
    empty = {"version": _version_key(), "warmed": {}}
    try:
        with open(_manifest_path(cache_dir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return empty
    if not isinstance(doc, dict) or doc.get("version") != empty["version"]:
        return empty
    if not isinstance(doc.get("warmed"), dict):
        return empty
    return doc


def record_warmed(cache_dir: str, entries: dict) -> None:
    """Merge ``entries`` ({key_str: {...}}) into the manifest atomically
    (temp file + rename: concurrent standbys warming the same dir may
    lose each other's merge but can never corrupt the document)."""
    doc = read_manifest(cache_dir)
    doc["warmed"].update(entries)
    tmp = (_manifest_path(cache_dir)
           + f".tmp.{os.getpid()}.{threading.get_ident()}")
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, _manifest_path(cache_dir))
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# 4. Hit/miss registry (the solver chokepoints report here)
# ---------------------------------------------------------------------------

_seen_lock = threading.Lock()
_seen: set = set()  # guarded-by: _seen_lock

#: Flat per-solve-key estimate (a ~10-slot tuple of ints/strs + the set
#: slot).  Hook and auditor share it, so audit_mem_ledgers checks hook
#: coverage, not estimate quality (doc/OBSERVABILITY.md "Memory ledger").
_KEY_EST = 160


def _seen_actual_nbytes(seen: set) -> int:
    with _seen_lock:
        return len(seen) * _KEY_EST


def _track_seen():
    from ..metrics import memledger
    with _seen_lock:  # registration keys off the set's identity
        return memledger.ledger("compile_cache").track(
            _seen, sizer=_seen_actual_nbytes)


_mem_seen = _track_seen()


def _mem_seen_add(n: int) -> None:
    from ..metrics import memledger
    memledger.ledger("compile_cache").add(_mem_seen, n)


def _dtype_name(leaf) -> str:
    """A leaf's dtype by name, the same for a numpy staging and the
    tensors it ships to ("float32", not "torch.float32")."""
    return str(leaf.dtype).replace("torch.", "")


def solve_key(choice: str, inp, cfg) -> tuple:
    """In-process identity of one solve signature: routing choice + the
    padded axis shapes (P/N/J/Q/R and the port/selector/signature pads),
    the float key dtype, and the conf.  Equal for a numpy staging and the
    tensors it ships to."""
    return (choice,
            tuple(int(d) for d in inp.task_req.shape),   # (P, R)
            tuple(int(d) for d in inp.node_idle.shape),  # (N, R)
            int(inp.job_start.shape[0]),                 # J
            int(inp.queue_deserved.shape[0]),            # Q
            int(inp.task_ports.shape[1]),                # NP pad
            int(inp.task_aff_req.shape[1]),              # NS pad
            int(inp.sig_mask.shape[0]),                  # S
            _dtype_name(inp.job_ts),                     # float key dtype
            cfg)


def note_solve_key(key: tuple) -> bool:
    """Record one dispatch under ``key``; returns True on a compile-cache
    hit (the signature was warmed or already dispatched in-process).
    Used directly by callers that build their own identity (the batched
    eviction dispatch, ops/evict_solver.evict_solve_key; the box scan;
    the fused program)."""
    from ..metrics import metrics

    with _seen_lock:
        hit = key in _seen
        _seen.add(key)
    if not hit:
        _mem_seen_add(_KEY_EST)
    metrics.note_compile_cache(hit)
    return hit


def note_solve(choice: str, inp, cfg) -> bool:
    """Record one routed solve; returns True on a compile-cache hit (the
    signature was warmed or already solved in-process).  O(1): a tuple
    of ints + one set probe per session."""
    return note_solve_key(solve_key(choice, inp, cfg))


def note_warmed(key: tuple) -> None:
    """Mark a signature as built (warmup path) WITHOUT counting it as a
    live hit or miss — warmup is setup, not traffic."""
    with _seen_lock:
        added = key not in _seen
        _seen.add(key)
    if added:
        _mem_seen_add(_KEY_EST)


def reset_seen() -> None:
    """Test hook: forget every in-process signature."""
    from ..metrics import memledger
    with _seen_lock:
        _seen.clear()
    memledger.ledger("compile_cache").set(_mem_seen, 0)


# ---------------------------------------------------------------------------
# 2. Warmup inputs + the warmup run
# ---------------------------------------------------------------------------

def make_bucket_inputs(spec: BucketSpec, r: int = 2, np_pad: int = 8,
                       ns_pad: int = 8, n_sigs: int = 1, dtype=None):
    """Zero-valued, numpy-staged SolverInputs at ``spec``'s padded bucket,
    leaf for leaf identical in shape and dtype to what tensorize_session
    stages for a featureless session of those sizes (``dtype`` is the
    float key dtype, torch.float32 by default).  All queues are
    non-existent, so the solve returns at once: K1's queue pop finds
    nothing."""
    import numpy as np
    import torch

    from .resources import EPS_QUANTA
    from .solver import SolverInputs

    dtype = torch.float32 if dtype is None else dtype
    p, n, j, q = spec.padded()
    r = max(r, 2)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def f(*shape):
        return np.zeros(shape, np_dtype)

    def i(*shape):
        return np.zeros(shape, np.int32)

    def b(*shape):
        return np.zeros(shape, bool)

    return SolverInputs(
        task_req=i(p, r), task_res=i(p, r), task_sig=i(p),
        task_sorted=np.arange(p, dtype=np.int32),
        task_ports=b(p, np_pad), task_aff_req=b(p, ns_pad),
        task_anti=b(p, ns_pad), task_match=b(p, ns_pad),
        task_paff_w=i(p, ns_pad), task_panti_w=i(p, ns_pad),
        job_start=i(j), job_count=i(j), job_queue=i(j),
        job_minavail=np.full((j,), -1, np.int32),
        job_prio=f(j), job_ts=f(j), job_uid_rank=f(j),
        job_init_ready=i(j), job_init_alloc=i(j, r),
        queue_deserved=i(q, r), queue_deserved_f=f(q, r),
        queue_init_alloc=i(q, r), queue_ts=f(q), queue_uid_rank=f(q),
        queue_exists=b(q),
        node_idle=i(n, r), node_releasing=i(n, r), node_used=i(n, r),
        node_alloc=i(n, r), node_count=i(n), node_max_tasks=i(n),
        node_exists=b(n), node_ports=b(n, np_pad),
        node_selcnt=i(n, ns_pad),
        sig_mask=b(max(n_sigs, 1), n), sig_bonus=i(max(n_sigs, 1), n),
        total_res=f(r),
        eps=np.full((r,), EPS_QUANTA, dtype=np.int32),
        scalar_dims=np.asarray([False, False] + [True] * (r - 2)),
        score_shift=i(2),
        node_coords=np.full((n, 8), -1, np.int32))


class WarmupRecord(NamedTuple):
    spec: BucketSpec
    solver: str
    key: tuple
    compile_ms: float
    error: Optional[str] = None


def _resolve_family(family: Sequence[str], device, inp=None) -> List[str]:
    """Expand ``family`` names to the allocate solvers to warm on
    ``device``.  ``auto`` = the route best_solve_allocate takes for
    ``inp`` there (``sharded`` where the mesh gate shards it, else
    ``cuda`` on the card and ``torch`` on the CPU); ``cuda`` only on the
    card; ``torch`` is the plain version; ``sharded`` only with a mesh
    (parallel.mesh.default_mesh) the node bucket divides into."""
    from ..parallel.mesh import default_mesh
    from .solver import choose_solver_mesh
    out: List[str] = []
    for name in family:
        if name == "auto":
            if inp is not None and choose_solver_mesh(inp)[0] == "sharded":
                out.append("sharded")
            else:
                out.append("cuda" if device.type == "cuda" else "torch")
        elif name == "cuda":
            if device.type == "cuda":
                out.append("cuda")
        elif name == "torch":
            out.append("torch")
        elif name == "sharded":
            mesh = default_mesh()
            if mesh is not None and inp is not None \
                    and inp.node_idle.shape[0] % mesh.size == 0:
                out.append("sharded")
        else:
            raise ValueError(f"unknown warmup solver {name!r}")
    deduped: List[str] = []
    for name in out:
        if name not in deduped:
            deduped.append(name)
    return deduped


def _readback(*tensors) -> None:
    """Force completion by reading the tensors to the host (warmup is
    setup: no chaos site, no span, no route count)."""
    for t in tensors:
        t.cpu()


def _record(spec, name, key, start, exc=None) -> WarmupRecord:
    ms = round((time.perf_counter() - start) * 1e3, 1)
    if exc is not None:
        text = f"{type(exc).__name__}: {exc}"
        log.warning("warmup of %s for %s failed after %.1f ms: %s", name,
                    tuple(spec), ms, text)
        return WarmupRecord(spec, name, key, ms, text)
    note_warmed(key)
    return WarmupRecord(spec, name, key, ms)


def warm_bucket(spec: BucketSpec, cfg=None, family: Sequence[str] = ("auto",),
                r: int = 2, device=None, dtype=None) -> List[WarmupRecord]:
    """Build (and persist, when the cache dir is enabled) and run the
    solver family for one bucket on zero-valued inputs shipped through a
    ``DeviceResidentShipper``.  Returns one record per member; a member's
    failure is recorded and logged, not raised (warmup must never take
    down boot)."""
    import contextlib

    import torch

    from ..device import check_float_dtype, resolve_device
    from ..models.shipping import DeviceResidentShipper
    from .cuda_solver import solve_allocate_cuda, solve_allocate_plain
    from .solver import SolverConfig

    device = resolve_device(device)
    dtype = check_float_dtype(torch.float32 if dtype is None else dtype)
    if cfg is None:
        cfg = SolverConfig()
    inp_np = make_bucket_inputs(spec, r=r, dtype=dtype)
    names = _resolve_family(family, device, inp_np)
    records: List[WarmupRecord] = []
    scope = (torch.cuda.device(device) if device.type == "cuda"
             else contextlib.nullcontext())
    with scope:
        shipper = DeviceResidentShipper(device)
        inp = shipper.ship(inp_np, cfg, dtype)
        if _is_sharded(inp):
            # Live sessions reach the sharded solve through the shipper's
            # sharded resident layout: delta-ship one dirtied row too, so
            # the per-shard scatter has run before the first session.
            dirty = inp_np._replace(node_count=inp_np.node_count.copy())
            dirty.node_count[0] += 1
            shipper.ship(dirty, cfg, dtype)
            inp = shipper.ship(inp_np, cfg, dtype)
        for name in names:
            key = solve_key(name, inp_np, cfg)
            start = time.perf_counter()
            try:
                if name == "sharded":
                    from ..parallel.mesh import default_mesh
                    from ..parallel.sharded_solver import \
                        solve_allocate_sharded
                    result = solve_allocate_sharded(inp, cfg, default_mesh())
                else:
                    from ..parallel.mesh import gathered
                    solve = (solve_allocate_cuda if name == "cuda"
                             else solve_allocate_plain)
                    result = solve(gathered(inp), cfg)[0]
                _readback(result.assignment, result.kind, result.order)
            except Exception as exc:  # lint: allow-swallow(warmup must never take down boot; failure is recorded in WarmupRecord.error and logged)
                records.append(_record(spec, name, key, start, exc))
                continue
            records.append(_record(spec, name, key, start))
        records.append(_warm_evict_batch(spec, cfg, inp_np, inp))
        records.append(_warm_candidate(spec, cfg, inp))
        from ..models.topology import topology_enabled
        if topology_enabled():
            records.append(_warm_topo(spec, device))
        from .fused_solver import fused_enabled
        if fused_enabled():
            records.append(_warm_fused(spec, cfg, inp_np, inp))
    return records


def _is_sharded(inp) -> bool:
    from ..parallel.mesh import shard_mesh
    return shard_mesh(inp) is not None


def _scan_statics(inp):
    from .scan import ScanStatics
    return ScanStatics(
        sig_mask=inp.sig_mask.clone(), sig_bonus=inp.sig_bonus.clone(),
        node_alloc=inp.node_alloc.clone(),
        node_max_tasks=inp.node_max_tasks.clone(),
        node_exists=inp.node_exists.clone(),
        score_shift=inp.score_shift.clone())


def _evict_staging(inp_np, spec: BucketSpec, device):
    """The batched eviction dispatch's staging at this bucket, as the
    scanner stages it: the packed node state, one profile row bucket and
    the victim buckets, all padding."""
    import numpy as np
    import torch

    r = inp_np.task_req.shape[1]
    np_pad = inp_np.task_ports.shape[1]
    ns_pad = inp_np.task_aff_req.shape[1]
    n_pad = inp_np.node_idle.shape[0]
    kb = bucket(1)
    mb = bucket(max(spec.tasks, 1))
    dyn = np.concatenate(
        [inp_np.node_used, inp_np.node_count[:, None],
         inp_np.node_ports.astype(np.int32), inp_np.node_selcnt],
        axis=1).astype(np.int32)
    trows = np.zeros((kb, 1 + r + np_pad + 4 * ns_pad), np.int32)
    vic_node = np.full((mb,), n_pad, np.int32)
    vic_rank = np.full((mb,), mb, np.int32)
    return ((r, np_pad, ns_pad, n_pad, kb, mb),
            tuple(torch.as_tensor(a, device=device)
                  for a in (dyn, trows, vic_node, vic_rank)))


def _warm_fused(spec: BucketSpec, cfg, inp_np, inp) -> WarmupRecord:
    """Run the fused one-dispatch session program (ops/fused_solver.py)
    at this bucket once: the allocate solve plus the batched eviction
    scan (plus the storm half's post-eviction adjustment when
    FUSED_STORM is on, plus the box scan when topology is enabled) in
    one enqueue sequence, as the first fused session would.  Other leg
    subsets run their members, each warmed above."""
    import numpy as np
    import torch

    from .. import knobs
    from ..models.topology import topology_enabled
    from .fused_solver import _fused_program, fused_solve_key
    from .solver import choose_solver_mesh, discard_solve

    device = inp.node_idle.device
    (r, np_pad, ns_pad, n_pad, kb, mb), (dyn, trows, vic_node, vic_rank) = \
        _evict_staging(inp_np, spec, device)
    legs = ["evict", "solve"]
    if knobs.FUSED_STORM.enabled():
        # The eviction-heavy storm variant (doc/FUSED.md "Storm half")
        # is the program a reclaim ladder dispatches.
        legs.append("postevict")
    if topology_enabled():
        legs.append("topo")
    legs = tuple(legs)
    from .evict_solver import choose_evict_route
    from .topo_solver import choose_topo_route
    aroute, amesh = choose_solver_mesh(inp)
    eroute = choose_evict_route(inp)[0]
    troute, tmesh = (choose_topo_route(n_pad) if "topo" in legs
                     else ("torch", None))
    sx, sy, sz = (2, 2, 2) if "topo" in legs else (0, 0, 0)
    key = fused_solve_key(legs, aroute, False, 0, (n_pad, cfg), eroute,
                          (cfg, r, np_pad, ns_pad, kb, mb), troute,
                          (sx, sy, sz))
    start = time.perf_counter()
    try:
        pe_res = pe_queue = pe_job = None
        if "postevict" in legs:
            # All-sentinel staging (no victims): the adjustment runs the
            # same scatters and solve as a live storm.
            qb = int(inp_np.queue_exists.shape[0])
            jb = int(inp_np.job_start.shape[0])
            pe_res = torch.zeros((mb, r), dtype=torch.int32, device=device)
            pe_queue = torch.full((mb,), qb, dtype=torch.int32,
                                  device=device)
            pe_job = torch.full((mb,), jb, dtype=torch.int32, device=device)
        box = None
        if "topo" in legs:
            from .topo_solver import BoxInputs, stage_box_inputs
            box = stage_box_inputs(BoxInputs(
                coords=np.full((n_pad, 8), -1, np.int32),
                free=np.zeros((n_pad,), bool),
                evictable=np.zeros((n_pad,), bool),
                vic_cnt=np.zeros((n_pad,), np.int32),
                vic_cost=np.zeros((n_pad,), np.int32)), device)
        sharded = eroute == "sharded"
        out = _fused_program(
            legs, cfg, False, inp, None, None, None, None, amesh, cfg, r,
            np_pad, ns_pad, _scan_statics(inp), None if sharded else dyn,
            inp if sharded else None, trows, vic_node, vic_rank, box, sx,
            sy, sz, tmesh, pe_res, pe_queue, pe_job)
        pending = out["alloc"]
        try:
            if pending.ready is not None:
                pending.ready.synchronize()
        finally:
            discard_solve(pending)
        _readback(*out["evict"][:2])
        if "postevict" in legs:
            _readback(*out["postevict"][:2])
        if "topo" in legs:
            _readback(out["topo"][0])
    except Exception as exc:  # lint: allow-swallow(warmup must never take down boot; failure is recorded in WarmupRecord.error and logged)
        return _record(spec, "fused", key, start, exc)
    return _record(spec, "fused", key, start)


def _warm_topo(spec: BucketSpec, device) -> WarmupRecord:
    """Run the batched slice box scan (ops/topo_solver.py) at this node
    bucket for the documented default slice shape, through the same
    dispatch chokepoint the live topo-allocate action uses (so, as in
    the reference, it counts one route and one compile-cache probe).
    Skipped entirely when KUBE_BATCH_TPU_TOPOLOGY=0 (warm_bucket gates
    the append)."""
    import numpy as np

    from . import topo_solver as ts

    # The default slice shape every in-repo gate exercises.
    shape = (2, 2, 2)
    n_pad = bucket(max(spec.nodes, 1))
    route, _mesh = ts.choose_topo_route(n_pad)
    key = ts.topo_solve_key(route, n_pad, shape)
    start = time.perf_counter()
    try:
        inp = ts.BoxInputs(
            coords=np.full((n_pad, 8), -1, np.int32),
            free=np.zeros((n_pad,), bool),
            evictable=np.zeros((n_pad,), bool),
            vic_cnt=np.zeros((n_pad,), np.int32),
            vic_cost=np.zeros((n_pad,), np.int32))
        ts.dispatch_box_scan(inp, shape, device)
    except Exception as exc:  # lint: allow-swallow(warmup must never take down boot; failure is recorded in WarmupRecord.error and logged)
        return _record(spec, "topo_box", key, start, exc)
    return _record(spec, "topo_box", key, start)


def _warm_candidate(spec: BucketSpec, cfg, inp) -> WarmupRecord:
    """Run K1 on gathered candidate rows (ops/prefilter.py) at the
    smallest candidate bucket — where micro churn cycles land — so the
    first prefiltered session meets a warmed signature."""
    import torch

    from .cuda_solver import solve_allocate_cuda, solve_allocate_plain
    from .solver import _gather_candidate_inputs, choose_solver_mesh

    cb = bucket(1)
    key: tuple = ("candidate", spec, cb)
    start = time.perf_counter()
    try:
        if _is_sharded(inp):
            # The per-shard gather and the sharded solve at the candidate
            # bucket, through the live dispatch's entry points.
            import numpy as np

            from ..parallel.mesh import shard_mesh
            from ..parallel.sharded_solver import (gather_candidate_sharded,
                                                   solve_allocate_sharded)
            mesh = shard_mesh(inp)
            sub = gather_candidate_sharded(
                inp, np.zeros((mesh.size, cb), np.int32),
                np.zeros((mesh.size, cb), bool), mesh)
            key = solve_key("sharded", sub, cfg)
            result = solve_allocate_sharded(sub, cfg, mesh)
            _readback(result.assignment, result.kind, result.order)
            return _record(spec, "candidate", key, start)
        dev = inp.node_idle.device
        idx = torch.zeros((cb,), dtype=torch.long, device=dev)
        valid = torch.zeros((cb,), dtype=torch.bool, device=dev)
        sub = _gather_candidate_inputs(inp, idx, valid)
        choice = choose_solver_mesh(sub)[0]
        key = solve_key(choice, sub, cfg)
        solve = solve_allocate_cuda if choice == "cuda" \
            else solve_allocate_plain
        result = solve(sub, cfg)[0]
        _readback(result.assignment, result.kind, result.order)
    except Exception as exc:  # lint: allow-swallow(warmup must never take down boot; failure is recorded in WarmupRecord.error and logged)
        return _record(spec, "candidate", key, start, exc)
    return _record(spec, "candidate", key, start)


def _warm_evict_batch(spec: BucketSpec, cfg, inp_np, inp) -> WarmupRecord:
    """Run the batched eviction scan (ops/evict_solver.py) at this
    bucket: at the smallest profile bucket (storms interleave a handful
    of preemptor profiles) and the node and victim buckets this spec
    implies.  A direct call, not the dispatch chokepoint: warmup is
    setup, not traffic — it must not count routes or hit a chaos
    site."""
    from .evict_solver import (choose_evict_route, evict_batch_solve,
                               evict_solve_key)

    device = inp.node_idle.device
    (r, np_pad, ns_pad, n_pad, kb, mb), (dyn, trows, vic_node, vic_rank) = \
        _evict_staging(inp_np, spec, device)
    route, mesh = choose_evict_route(inp)
    key = evict_solve_key(cfg, r, np_pad, ns_pad, n_pad, kb, mb,
                          int(inp_np.sig_mask.shape[0]), route=route)
    start = time.perf_counter()
    try:
        if route == "sharded":
            from ..parallel.sharded_scan import evict_batch_solve_sharded
            scores, perm = evict_batch_solve_sharded(
                cfg, r, np_pad, ns_pad, _scan_statics(inp), inp.node_used,
                inp.node_count, inp.node_ports, inp.node_selcnt, trows,
                vic_node, vic_rank, mesh)
        else:
            scores, perm = evict_batch_solve(
                cfg, r, np_pad, ns_pad, _scan_statics(inp), dyn, trows,
                vic_node, vic_rank)
        _readback(scores, perm)
    except Exception as exc:  # lint: allow-swallow(warmup must never take down boot; failure is recorded in WarmupRecord.error and logged)
        return _record(spec, "evict_batch", key, start, exc)
    return _record(spec, "evict_batch", key, start)


class SolverWarmup:
    """Background startup warmup: build and run the solver family for
    each configured bucket off the scheduler thread, so the first live
    session of a warmed bucket meets a built library, a sized pool and a
    warmed signature.

    ``start`` is idempotent (one thread per instance, ever); ``stop``
    signals between buckets — a build in flight cannot be interrupted, so
    the thread is a daemon and stop() bounds its own wait instead of the
    process exit."""

    def __init__(self, buckets: Iterable[BucketSpec], cfg=None,
                 family: Sequence[str] = ("auto",),
                 cache_dir: Optional[str] = None, device=None, dtype=None):
        import torch

        from ..device import check_float_dtype, resolve_device
        self.buckets = list(buckets)
        self._cfg = cfg
        self._family = tuple(family)
        self._cache_dir = cache_dir
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The caller's current card: the thread sets it explicitly.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.dtype = check_float_dtype(
            torch.float32 if dtype is None else dtype)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self.records: List[WarmupRecord] = []
        self.errors: List[str] = []

    def start(self) -> "SolverWarmup":
        with self._lock:
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._run, name="solver-warmup", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        from ..metrics import metrics

        manifest: dict = {}
        try:
            if self.device.type == "cuda":
                import torch
                try:
                    torch.cuda.set_device(self.device)
                except Exception as exc:  # noqa: BLE001 - never kill boot
                    self.errors.append(f"set_device({self.device}): "
                                       f"{type(exc).__name__}: {exc}")
                    log.warning("warmup cannot use %s: %s", self.device,
                                exc)
                    return
            for k, spec in enumerate(self.buckets):
                if self._stop.is_set():
                    break
                metrics.set_compile_inflight(len(self.buckets) - k)
                try:
                    records = warm_bucket(spec, cfg=self._cfg,
                                          family=self._family,
                                          device=self.device,
                                          dtype=self.dtype)
                except Exception as exc:  # noqa: BLE001 - never kill boot
                    self.errors.append(f"{spec}: {type(exc).__name__}: {exc}")
                    log.warning("warmup of bucket %s failed: %s: %s",
                                tuple(spec), type(exc).__name__, exc)
                    continue
                self.records.extend(records)
                for rec in records:
                    if rec.error:
                        self.errors.append(
                            f"{rec.spec}/{rec.solver}: {rec.error}")
                    else:
                        manifest[repr(rec.key)] = self._entry(rec)
        finally:
            metrics.set_compile_inflight(0)
            if self._cache_dir and manifest:
                record_warmed(self._cache_dir, manifest)

    @staticmethod
    def _entry(rec: WarmupRecord) -> dict:
        """One manifest entry: the reference's fields, when it was
        warmed, and for a K1 member whether this process built the
        library with nvcc or loaded one from the build directory."""
        entry = {"spec": list(rec.spec), "solver": rec.solver,
                 "compile_ms": rec.compile_ms, "warmed_at": time.time()}
        if rec.solver in ("cuda", "candidate", "fused"):
            from .cuda_solver import _Kernel
            if _Kernel.built is not None:
                entry["library"] = "built" if _Kernel.built else "loaded"
        return entry

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    def stop(self, timeout: float = 0.0) -> None:
        self._stop.set()
        self.join(timeout)

    @property
    def done(self) -> bool:
        t = self._thread
        return t is not None and not t.is_alive()
