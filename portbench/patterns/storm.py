"""The storm pattern: a preemption storm on a full cluster, several
sessions a cycle.

Each cycle:

- restore, outside every metric: the last wave's pods and pod groups are
  deleted, and every node that lost a resident in the last cycle gets its
  residents back, Running, in their first order (its surviving residents
  are deleted and all are added again), so every cycle starts from the
  same cluster;
- the wave is ingested through the cache's handlers; its due time is the
  start of that ingest;
- then sessions run: ``Scheduler.run_once()``, then the pods that session
  evicted are deleted through the cache's handlers (their completion),
  until a session evicts nothing and binds nothing, or ``max_sessions``
  have run.

Every ``run_once()`` of the window counts in ``session_ms``, eviction and
bind sessions alike.  A preemptor's latency is its bind stamp minus its
wave's due time, so the deletion of victims between sessions lies inside
it; one still unbound when its cycle ends counts with the time to that
end, and in ``failed``.

Set-up builds the cluster and its residents through the informer, the
API objects of ``warmup_cycles + prebuilt_cycles`` waves (frozen with the
cluster, as the burst pattern does) and runs ``warmup_cycles`` whole
cycles.  The window runs cycles until ``seconds`` have passed and the
cycles drawn for the check have run.  The check holds every session of
each drawn cycle against ``reference/evict.py`` (``storm_check.py``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

from kube_batch_tpu_torch.api import pod_key
from kube_batch_tpu_torch.cache.interface import Evictor

from .. import generator, informer, storm_check
from ..reference import evict
from ..window import Session, Window
from .burst import Collector


class BatchEvictor(Evictor):
    """Records every egress batch of evicted pod keys, in order."""

    def __init__(self):
        self.batches: List[List[str]] = []

    def evict(self, pod) -> None:
        self.batches.append([pod_key(pod)])

    def evict_many(self, pods) -> list:
        self.batches.append([pod_key(p) for p in pods])
        return []

    def take(self) -> List[List[str]]:
        out, self.batches = self.batches, []
        return out


def new_cache():
    from kube_batch_tpu_torch.cache import SchedulerCache
    return SchedulerCache(binder=informer.StampBinder(),
                          evictor=BatchEvictor(),
                          status_updater=informer.StatusRecorder(),
                          volume_binder=informer.NullVolumeBinder())


def attribute(batches, flushes):
    """[(pod key, action)] in egress order: each batch the evictor saw,
    matched in order with the session's ``commit.flush`` spans (their
    ``action`` and ``batch`` args); a batch no flush accounts for is
    named ``?``, which the check counts as a mismatch."""
    out = []
    flushes = list(flushes)
    for keys in batches:
        action = "?"
        if flushes and flushes[0][1] == len(keys):
            action = flushes.pop(0)[0]
        out.extend((k, action) for k in keys)
    return out


class Storm:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.cluster = generator.make_cluster(config, seed)
        self.residents = storm_check.make_residents(config, self.cluster)
        self.cache = None
        self.scheduler = None
        self._live = None           # (groups, pods) of the wave in the cache
        self._built = {}            # cycle index -> its wave's API objects
        self._resident_pods = []    # resident index -> its Pod
        self._touched = set()       # nodes that lost a resident this cycle
        self._gone = set()          # residents deleted this cycle
        first = int(traffic["warmup_cycles"])
        among = int(traffic["checked_among"])
        k = min(int(traffic["checked_cycles"]), among)
        rng = generator.rng_for(seed, 2)
        self.sample = sorted(first + int(i) for i in
                             rng.choice(among, size=k, replace=False))
        self.observed: Dict[int, List[storm_check.Observed]] = {}
        self.statuses: dict = {}    # pod group key -> last pushed status

    def _wave(self, index: int):
        return storm_check.make_wave(self.config, self.traffic, self.cluster,
                                     self.seed, index)

    def setup(self) -> None:
        from kube_batch_tpu_torch.scheduler import Scheduler
        self.cache = new_cache()
        gc.disable()
        try:
            pcs, groups, pods = storm_check.resident_objects(
                self.config, self.residents, self.cluster)
            self._resident_pods = pods
            for i in range(int(self.traffic["warmup_cycles"])
                           + int(self.traffic["prebuilt_cycles"])):
                self._built[i] = storm_check.wave_objects(
                    self._wave(i), self.cluster, self.traffic)
        finally:
            gc.enable()
        for pc in pcs:
            self.cache.add_priority_class(pc)
        informer.feed_cluster(self.cache, self.cluster)
        informer.ingest(self.cache, groups, pods)
        gc.collect()
        gc.freeze()
        self.scheduler = Scheduler(
            self.cache, scheduler_conf=self.config["scheduler_conf"],
            device=self.device)
        for i in range(int(self.traffic["warmup_cycles"])):
            self._cycle(i, phases=None)

    def _restore(self) -> None:
        cache = self.cache
        if self._live is not None:
            informer.delete(cache, *self._live)
            self._live = None
        if not self._touched:
            return
        on_node = self.residents.on_node
        pods = self._resident_pods
        gone = self._gone
        for n in sorted(self._touched):
            for r in on_node[n]:
                if r not in gone:
                    cache.delete_pod(pods[r])
            for r in on_node[n]:
                cache.add_pod(pods[r])
        self._touched = set()
        self._gone = set()

    def _cycle(self, index: int, phases: Optional[list]):
        """(the cycle's sessions, the wave's due time, its bind stamps,
        the cycle's end) of wave ``index``."""
        from kube_batch_tpu_torch.trace import flight_recorder

        def phase(name, a, b):
            if phases is not None:
                phases.append((name, a, b, 0))

        cache = self.cache
        t0 = time.perf_counter()
        self._restore()
        t1 = time.perf_counter()
        phase("restore", t0, t1)
        objects = self._built.pop(index, None)
        if objects is None:
            objects = storm_check.wave_objects(self._wave(index),
                                               self.cluster, self.traffic)
        due = time.perf_counter()
        if due - t1 > 1e-3:
            phase("wave.build", t1, due)
        informer.ingest(cache, *objects)
        self._live = objects
        ingest_end = time.perf_counter()
        phase("ingest", due, ingest_end)
        sessions, stamps = [], {}
        observed = [] if index in self.sample else None
        for _s in range(int(self.traffic["max_sessions"])):
            start = time.perf_counter()
            self.scheduler.run_once()
            end = time.perf_counter()
            binds, bound_at = cache.binder.take()
            stamps.update(bound_at)
            pushed = cache.status_updater.take()
            self.statuses.update(pushed)
            trace = flight_recorder.latest()
            spans = [] if trace is None else [
                (s.name, trace.t0 + s.ts * 1e-6,
                 trace.t0 + (s.ts + s.dur) * 1e-6, s.depth)
                for s in trace.spans]
            flushes = [] if trace is None else [
                (s.args.get("action"), s.args.get("batch"))
                for s in trace.spans if s.name == "commit.flush"]
            victims = attribute(cache.evictor.take(), flushes)
            if observed is not None:
                observed.append(storm_check.Observed(
                    victims=victims, binds=binds,
                    node_state=informer.node_state(cache, self.cluster),
                    statuses=dict(self.statuses)))
            t2 = time.perf_counter()
            phase("run_once", start, end)
            phase("record", end, t2)
            self._complete(victims)
            t3 = time.perf_counter()
            phase("release", t2, t3)
            sessions.append(Session(
                due=due, ingest_s=ingest_end - due, start=start, end=end,
                nodes=len(self.cluster.node_names), pods=len(objects[1]),
                jobs=len(objects[0]), queues=len(self.cluster.queue_names),
                placements=len(binds), spans=spans))
            if not victims and not binds:
                break
        if observed is not None:
            self.observed[index] = observed
        return sessions, due, stamps, time.perf_counter()

    def _complete(self, victims) -> None:
        """The victims' completion: each evicted resident is deleted
        through the cache's handlers."""
        key_index = self.residents.key_index
        for key, _action in victims:
            r = key_index.get(key)
            if r is None:
                continue
            self.cache.delete_pod(self._resident_pods[r])
            self._gone.add(r)
            self._touched.add(int(self.residents.node[r]))

    def window(self, seconds: float) -> Window:
        runs, phases = [], []
        index = int(self.traffic["warmup_cycles"])
        collector = Collector()
        gc.callbacks.append(collector)
        try:
            start = time.perf_counter()
            while (time.perf_counter() - start < seconds
                   or index <= self.sample[-1]):
                runs.append(self._cycle(index, phases))
                index += 1
            end = time.perf_counter()
        finally:
            gc.callbacks.remove(collector)
        latencies, failed, sessions = [], 0, []
        wave_pods = int(self.traffic["wave_pods"])
        for cycle_sessions, due, stamps, cycle_end in runs:
            sessions.extend(cycle_sessions)
            got = [t - due for t in stamps.values()]
            missing = wave_pods - len(got)
            failed += missing
            latencies.extend(got)
            latencies.extend([cycle_end - due] * missing)
        return Window(start=start, end=end, sessions=sessions,
                      latencies=latencies, attempted=len(latencies),
                      failed=failed, phases=phases + collector.full,
                      gc_s=collector.seconds)

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.scheduler = None
        self.cache = None
        self._live = None
        self._built.clear()
        self._resident_pods = []
        gc.unfreeze()
        gc.collect()
        try:
            import torch
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        except ImportError:
            pass

    def decide(self, index: int):
        """The reference's sessions for cycle ``index``."""
        w = self.config["nodeorder_weights"]
        return evict.run_cycle(
            self.cluster, self.residents, self._wave(index),
            weights=(w["leastrequested"], w["mostrequested"],
                     w["balancedresource"]),
            share_dtype=self.config["share_precision"],
            max_sessions=int(self.traffic["max_sessions"]))

    def check(self):
        """(correct, checks, checked cycles): every session of each cycle
        drawn before the window against the reference's."""
        totals = {}
        for index in self.sample:
            observed = self.observed.get(index)
            if observed is None:
                totals = storm_check.add(totals, {"unrun_cycles": 1})
                continue
            try:
                decided = self.decide(index)
            except evict.OutOfScope:
                totals = storm_check.add(totals, {"out_of_scope": 1})
                continue
            totals = storm_check.add(totals, storm_check.compare(
                self.cluster, self.residents, self._wave(index), decided,
                observed))
        correct, checks = storm_check.verdict(totals)
        return correct, checks, list(self.sample)


Pattern = Storm
