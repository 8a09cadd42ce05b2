"""Resource vector algebra.

Semantics mirror the reference scheduler's float64 resource math
(kube-batch pkg/scheduler/api/resource_info.go:28-302), including the
epsilon comparison thresholds (minMilliCPU=10, minMemory=10MiB, minScalar=10)
that every fit decision depends on.  The host-side model keeps Python floats
(IEEE float64, same as Go); the device-side tensors in
``kube_batch_tpu.models.tensor_snapshot`` quantize the same values into a
fixed resource axis with the same epsilons, so host and TPU paths agree.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional

import numpy as _np

# Epsilons under which two quantities are considered equal / a quantity is
# considered zero (reference resource_info.go:68-70).
MIN_MILLI_CPU = 10.0
MIN_MILLI_SCALAR = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024

GPU_RESOURCE_NAME = "nvidia.com/gpu"
TPU_RESOURCE_NAME = "google.com/tpu"

_QUANTITY_RE = re.compile(
    r"^([+-]?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+))([a-zA-Z][a-zA-Z0-9+-]*)?$")

_SUFFIX = {
    "": 1.0,
    "n": 1e-9, "u": 1e-6, "m": 1e-3,
    "k": 1e3, "K": 1e3, "Ki": 1024.0,
    "M": 1e6, "Mi": 1024.0 ** 2,
    "G": 1e9, "Gi": 1024.0 ** 3,
    "T": 1e12, "Ti": 1024.0 ** 4,
    "P": 1e15, "Pi": 1024.0 ** 5,
    "E": 1e18, "Ei": 1024.0 ** 6,
}


def parse_quantity(q) -> float:
    """Parse a Kubernetes-style quantity to a float.

    Accepts the full legal quantity grammar (apimachinery resource.Quantity):
    plain numbers ("2", 1.5), signs ("-1"), SI/binary suffixes from "n" up to
    "Ei" ("250m", "1Gi"), and decimal-exponent notation ("1e3", "12E2").
    """
    if isinstance(q, (int, float)):
        return float(q)
    m = _QUANTITY_RE.match(str(q).strip())
    if not m:
        raise ValueError(f"invalid quantity: {q!r}")
    value, suffix = m.groups()
    suffix = suffix or ""
    # Exponent form: "e"/"E" followed by a (signed) integer. A bare "E" is
    # the exa suffix, not an exponent.
    if len(suffix) > 1 and suffix[0] in "eE":
        exp = suffix[1:]
        if exp[0] in "+-":
            exp = exp[1:]
        if exp.isdigit():
            return float(value + suffix)
    if suffix not in _SUFFIX:
        raise ValueError(f"invalid quantity suffix: {q!r}")
    return float(value) * _SUFFIX[suffix]


def is_scalar_resource_name(name: str) -> bool:
    """IsScalarResourceName analog (k8s.io v1helper helpers.go:100-104, cited
    by the reference's NewResource at resource_info.go:84): extended resources
    ('/'-qualified, outside *kubernetes.io/, not "requests."-prefixed),
    hugepages-*, *kubernetes.io/-prefixed native names, and
    attachable-volumes-*.  Anything else (e.g. ephemeral-storage) is NOT a
    fit-relevant scalar dimension."""
    if name.startswith("hugepages-") or name.startswith("attachable-volumes-"):
        return True
    if "kubernetes.io/" in name:  # IsPrefixedNativeResource: *kubernetes.io/
        return True
    return ("/" in name  # extended: qualified, non-native, not quota-form
            and not name.startswith("requests."))


class Resource:
    """A resource vector: milli-CPU, bytes of memory, and named scalars.

    Scalar resources (GPUs, TPUs, extended resources) are stored in
    milli-units, mirroring ``NewResource`` (resource_info.go:73-93).
    ``max_task_num`` is only used by predicates and is excluded from
    arithmetic, like the reference's ``MaxTaskNum``.
    """

    __slots__ = ("milli_cpu", "memory", "scalar_resources", "max_task_num")

    def __init__(self, milli_cpu: float = 0.0, memory: float = 0.0,
                 scalar_resources: Optional[Dict[str, float]] = None,
                 max_task_num: int = 0):
        self.milli_cpu = float(milli_cpu)
        self.memory = float(memory)
        self.scalar_resources: Dict[str, float] = dict(scalar_resources or {})
        self.max_task_num = max_task_num

    # -- constructors -------------------------------------------------------

    @classmethod
    def empty(cls) -> "Resource":
        return cls()

    @classmethod
    def from_resource_list(cls, rl: Dict[str, object]) -> "Resource":
        """Build from a resource-list dict, e.g. {"cpu": "2", "memory": "1Gi",
        "pods": 110, "nvidia.com/gpu": 1}.  CPU and scalars go to
        milli-units; memory to bytes (resource_info.go:73-93)."""
        r = cls()
        for name, quantity in (rl or {}).items():
            v = parse_quantity(quantity)
            if name == "cpu":
                r.milli_cpu += v * 1000.0
            elif name == "memory":
                r.memory += v
            elif name == "pods":
                r.max_task_num += int(v)
            elif is_scalar_resource_name(name):
                r.scalar_resources[name] = r.scalar_resources.get(name, 0.0) + v * 1000.0
        return r

    def clone(self) -> "Resource":
        r = Resource.__new__(Resource)  # skip __init__ float coercions
        r.milli_cpu = self.milli_cpu
        r.memory = self.memory
        r.scalar_resources = dict(self.scalar_resources)
        r.max_task_num = self.max_task_num
        return r

    # -- predicates ---------------------------------------------------------

    def is_empty(self) -> bool:
        """True iff every dimension is below its epsilon (resource_info.go:96-108)."""
        if not (self.milli_cpu < MIN_MILLI_CPU and self.memory < MIN_MEMORY):
            return False
        return all(q < MIN_MILLI_SCALAR for q in self.scalar_resources.values())

    def is_zero(self, name: str) -> bool:
        if name == "cpu":
            return self.milli_cpu < MIN_MILLI_CPU
        if name == "memory":
            return self.memory < MIN_MEMORY
        if not self.scalar_resources:
            return True
        if name not in self.scalar_resources:
            raise KeyError(f"unknown resource {name}")
        return self.scalar_resources[name] < MIN_MILLI_SCALAR

    # -- arithmetic (mutating, like the reference) --------------------------

    def add(self, rr: "Resource") -> "Resource":
        self.milli_cpu += rr.milli_cpu
        self.memory += rr.memory
        for name, q in rr.scalar_resources.items():
            self.scalar_resources[name] = self.scalar_resources.get(name, 0.0) + q
        return self

    def sub(self, rr: "Resource") -> "Resource":
        """Subtract; raises if rr does not fit (resource_info.go:149-168)."""
        if not rr.less_equal(self):
            raise ValueError(
                f"Resource is not sufficient to do operation: {self} sub {rr}")
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        if not self.scalar_resources:
            return self
        for name, q in rr.scalar_resources.items():
            self.scalar_resources[name] = self.scalar_resources.get(name, 0.0) - q
        return self

    def sub_lenient(self, rr: "Resource") -> "Resource":
        """Subtract without the sufficiency check.  Batch apply uses this:
        the per-task sequential path tolerates epsilon-sized overdraft at
        every step, so the batched equivalent must reproduce the same final
        vector (idle - sum) rather than re-checking the aggregate."""
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        for name, q in rr.scalar_resources.items():
            self.scalar_resources[name] = self.scalar_resources.get(name, 0.0) - q
        return self

    def multi(self, ratio: float) -> "Resource":
        self.milli_cpu *= ratio
        self.memory *= ratio
        for name in self.scalar_resources:
            self.scalar_resources[name] *= ratio
        return self

    def set_max_resource(self, rr: "Resource") -> None:
        """Per-dimension max, in place (resource_info.go:171-199)."""
        if rr is None:
            return
        self.milli_cpu = max(self.milli_cpu, rr.milli_cpu)
        self.memory = max(self.memory, rr.memory)
        for name, q in rr.scalar_resources.items():
            if q > self.scalar_resources.get(name, 0.0):
                self.scalar_resources[name] = q

    def fit_delta(self, rr: "Resource") -> "Resource":
        """Available minus requested with epsilon margin; negative fields mean
        insufficient resource (resource_info.go:205-227)."""
        if rr.milli_cpu > 0:
            self.milli_cpu -= rr.milli_cpu + MIN_MILLI_CPU
        if rr.memory > 0:
            self.memory -= rr.memory + MIN_MEMORY
        for name, q in rr.scalar_resources.items():
            if q > 0:
                self.scalar_resources[name] = (
                    self.scalar_resources.get(name, 0.0) - q - MIN_MILLI_SCALAR)
        return self

    # -- comparisons --------------------------------------------------------

    def less(self, rr: "Resource") -> bool:
        """Strict less on every dimension (resource_info.go:239-276), keeping
        the reference's asymmetric handling of absent scalar maps."""
        if not self.milli_cpu < rr.milli_cpu:
            return False
        if not self.memory < rr.memory:
            return False
        if not self.scalar_resources:
            if rr.scalar_resources:
                for q in rr.scalar_resources.values():
                    if q <= MIN_MILLI_SCALAR:
                        return False
            return True
        if not rr.scalar_resources:
            return False
        for name, q in self.scalar_resources.items():
            if not q < rr.scalar_resources.get(name, 0.0):
                return False
        return True

    def less_equal(self, rr: "Resource") -> bool:
        """Epsilon-tolerant <= on every dimension (resource_info.go:279-311)."""
        def le(l: float, r: float, diff: float) -> bool:
            return l < r or abs(l - r) < diff

        if not le(self.milli_cpu, rr.milli_cpu, MIN_MILLI_CPU):
            return False
        if not le(self.memory, rr.memory, MIN_MEMORY):
            return False
        if not self.scalar_resources:
            return True
        for name, q in self.scalar_resources.items():
            if q <= MIN_MILLI_SCALAR:
                continue
            if not rr.scalar_resources:
                return False
            if not le(q, rr.scalar_resources.get(name, 0.0), MIN_MILLI_SCALAR):
                return False
        return True

    def diff(self, rr: "Resource"):
        """Return (increased, decreased) vs rr (resource_info.go:314-346)."""
        inc, dec = Resource(), Resource()
        if self.milli_cpu > rr.milli_cpu:
            inc.milli_cpu = self.milli_cpu - rr.milli_cpu
        else:
            dec.milli_cpu = rr.milli_cpu - self.milli_cpu
        if self.memory > rr.memory:
            inc.memory = self.memory - rr.memory
        else:
            dec.memory = rr.memory - self.memory
        for name, q in self.scalar_resources.items():
            rq = rr.scalar_resources.get(name, 0.0)
            if q > rq:
                inc.scalar_resources[name] = inc.scalar_resources.get(name, 0.0) + q - rq
            else:
                dec.scalar_resources[name] = dec.scalar_resources.get(name, 0.0) + rq - q
        return inc, dec

    # -- accessors ----------------------------------------------------------

    def get(self, name: str) -> float:
        if name == "cpu":
            return self.milli_cpu
        if name == "memory":
            return self.memory
        return self.scalar_resources.get(name, 0.0)

    def set_scalar(self, name: str, quantity: float) -> None:
        self.scalar_resources[name] = quantity

    def add_scalar(self, name: str, quantity: float) -> None:
        self.scalar_resources[name] = self.scalar_resources.get(name, 0.0) + quantity

    def resource_names(self) -> Iterable[str]:
        return ["cpu", "memory", *self.scalar_resources.keys()]

    # -- dunder sugar -------------------------------------------------------

    def __eq__(self, other) -> bool:
        if not isinstance(other, Resource):
            return NotImplemented
        mine = {k: v for k, v in self.scalar_resources.items() if v}
        theirs = {k: v for k, v in other.scalar_resources.items() if v}
        return (self.milli_cpu == other.milli_cpu and self.memory == other.memory
                and mine == theirs)

    def __hash__(self):
        return hash((self.milli_cpu, self.memory,
                     tuple(sorted(self.scalar_resources.items()))))

    def __repr__(self) -> str:
        s = f"cpu {self.milli_cpu:.2f}, memory {self.memory:.2f}"
        for name, q in self.scalar_resources.items():
            s += f", {name} {q:.2f}"
        return s


def minimum(l: Resource, r: Resource) -> Resource:
    """Per-dimension min (reference api/helpers/helpers.go:27-44)."""
    res = Resource(min(l.milli_cpu, r.milli_cpu), min(l.memory, r.memory))
    if not l.scalar_resources or not r.scalar_resources:
        return res
    for name, q in l.scalar_resources.items():
        res.scalar_resources[name] = min(q, r.scalar_resources.get(name, 0.0))
    return res


def share(l: float, r: float) -> float:
    """Allocated/total with 0/0 -> 0 and x/0 -> 1 (helpers.go:47-59).

    Computed as a correctly-rounded float32 division of float32-rounded
    operands — the ONE operation every engine (host plugins, XLA solver,
    Pallas kernel, sharded solver; with and without jax_enable_x64) can
    reproduce bit-for-bit, so share-ordered decisions are identical on
    every path.  Deviation from the reference's float64: shares within
    ~2^-24 relative tie and fall to the deterministic creation-time/uid
    tie-break slightly more often; resource quanta are power-of-two
    scalings of the raw values, so host bytes and device quanta round to
    the same float32 mantissa and the quotients agree exactly."""
    if r == 0:
        return 0.0 if l == 0 else 1.0
    return float(_np.float32(l) / _np.float32(r))
