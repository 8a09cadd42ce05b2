"""The burst pattern: waves of pending gangs, one session each.

Each cycle: the previous wave completes (its pods and pod groups are
deleted through the cache's handlers, outside every metric); a fresh wave
is ingested through the handlers, its due time the start of that ingest;
one ``Scheduler.run_once()`` places it.  Every wave is new work, so the
scheduler's incremental path never reuses a solve.

The collector runs as the daemon runs it: the long-lived state is frozen
once the cluster has synced, ``run_once`` pauses the collector for the
session, and between sessions its passes fall where the program's own
allocations put them.  The window times every pass (``gc_ms``).

Set-up builds the cluster through the informer, builds the API objects
of ``prebuilt_waves`` waves (an informer's decoded objects, made before
the window so that the window holds the program's work), and runs
``warmup_waves`` whole cycles, which build and load every kernel and warm
every shape the window uses.  The window runs cycles until ``seconds``
have passed and the waves drawn for the check have run; the cycle under
way then ends, so the window closes when a session does.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

from .. import check, generator, informer
from ..reference import allocate
from ..window import Session, Window

# Host spans of the collector's full passes sit deepest, so that an idle
# stretch of the device names them over the phase they interrupt.
GC_DEPTH = 99


class Collector:
    """``gc.callbacks`` entry: the seconds of every pass, and the span of
    every full (generation 2) pass."""

    def __init__(self):
        self.seconds = 0.0
        self.full = []
        self._start = None

    def __call__(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._start = now
        elif self._start is not None:
            self.seconds += now - self._start
            if info.get("generation") == 2:
                self.full.append(("gc", self._start, now, GC_DEPTH))
            self._start = None


class Burst:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.cluster = generator.make_cluster(config, seed)
        self.cache = None
        self.scheduler = None
        self._live = None           # (groups, pods) of the wave in the cache
        self._built = {}            # wave index -> its API objects
        # The waves the check judges: drawn from the seed before the window,
        # among its first ``checked_among``.
        first = int(traffic["warmup_waves"])
        among = int(traffic["checked_among"])
        k = min(int(traffic["checked_waves"]), among)
        rng = generator.rng_for(seed, 2)
        self.sample = sorted(first + int(i) for i in
                             rng.choice(among, size=k, replace=False))
        self.observed = {}          # wave index -> check.Observed

    def _wave(self, index: int):
        return generator.make_wave(self.traffic, len(self.cluster.queue_names),
                                   self.seed, index)

    def setup(self) -> None:
        from kube_batch_tpu_torch.scheduler import Scheduler
        self.cache = informer.new_cache()
        informer.feed_cluster(self.cache, self.cluster)
        warmup = int(self.traffic["warmup_waves"])
        # The waves' objects are the harness's: the collector neither runs
        # while they are built nor scans them later.
        gc.disable()
        try:
            for i in range(warmup + int(self.traffic["prebuilt_waves"])):
                self._built[i] = informer.wave_objects(
                    self._wave(i), self.cluster, self.traffic)
        finally:
            gc.enable()
        # As the daemon's loop does once its cache has synced
        # (Scheduler.run): the long-lived cluster leaves the collector's
        # scan set, and with it the waves' API objects.
        gc.collect()
        gc.freeze()
        self.scheduler = Scheduler(
            self.cache, scheduler_conf=self.config["scheduler_conf"],
            device=self.device)
        for i in range(warmup):
            self._cycle(i, phases=None)

    def _cycle(self, index: int, phases: Optional[list]):
        """(the session, its bind stamps) of wave ``index``."""
        from kube_batch_tpu_torch.trace import flight_recorder

        def phase(name, a, b):
            if phases is not None:
                phases.append((name, a, b, 0))

        cache = self.cache
        t0 = time.perf_counter()
        if self._live is not None:
            informer.delete(cache, *self._live)
            self._live = None
        t1 = time.perf_counter()
        objects = self._built.pop(index, None)
        if objects is None:
            objects = informer.wave_objects(self._wave(index), self.cluster,
                                            self.traffic)
        due = time.perf_counter()
        informer.ingest(cache, *objects)
        self._live = objects
        start = time.perf_counter()
        self.scheduler.run_once()
        end = time.perf_counter()
        binds, stamps = cache.binder.take()
        statuses = cache.status_updater.take()
        if index in self.sample:
            self.observed[index] = check.Observed(
                binds=binds, node_state=informer.node_state(cache,
                                                            self.cluster),
                statuses=statuses)
        trace = flight_recorder.latest()
        spans = [] if trace is None else [
            (s.name, trace.t0 + s.ts * 1e-6, trace.t0 + (s.ts + s.dur) * 1e-6,
             s.depth) for s in trace.spans]
        t2 = time.perf_counter()
        phase("delete", t0, t1)
        if due - t1 > 1e-3:
            phase("wave.build", t1, due)
        phase("ingest", due, start)
        phase("run_once", start, end)
        phase("record", end, t2)
        n_pods = len(objects[1])
        return Session(due=due, ingest_s=start - due, start=start, end=end,
                       nodes=len(self.cluster.node_names), pods=n_pods,
                       jobs=len(objects[0]),
                       queues=len(self.cluster.queue_names),
                       placements=len(binds), spans=spans), stamps

    def window(self, seconds: float) -> Window:
        runs, phases = [], []
        index = int(self.traffic["warmup_waves"])
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
        latencies, failed = [], 0
        for session, stamps in runs:
            got = [t - session.due for t in stamps.values()]
            missing = session.pods - len(got)
            failed += missing
            latencies.extend(got)
            latencies.extend([end - session.due] * missing)
        return Window(start=start, end=end,
                      sessions=[s for s, _stamps in runs],
                      latencies=latencies, attempted=len(latencies),
                      failed=failed, phases=phases + collector.full,
                      gc_s=collector.seconds)

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        self.scheduler = None
        self.cache = None
        self._live = None
        self._built.clear()
        gc.unfreeze()
        gc.collect()
        try:
            import torch
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        except ImportError:
            pass

    def check(self):
        """(correct, checks, checked waves): the reference's decision for
        the waves drawn before the window against what the sessions did."""
        w = self.config["nodeorder_weights"]
        weights = (w["leastrequested"], w["mostrequested"],
                   w["balancedresource"])
        totals = {}
        for index in self.sample:
            observed = self.observed.get(index)
            if observed is None:
                totals = check.add(totals, {"unrun_waves": 1})
                continue
            try:
                decision = allocate.solve(
                    self.cluster, self._wave(index), weights=weights,
                    share_dtype=self.config["share_precision"])
            except allocate.OutOfScope:
                totals = check.add(totals, {"out_of_scope": 1})
                continue
            totals = check.add(totals, check.compare(
                self.cluster, self._wave(index), decision, observed))
        correct, checks = check.verdict(totals)
        return correct, checks, list(self.sample)


Pattern = Burst
