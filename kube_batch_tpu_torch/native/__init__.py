"""Native host-loop kernels (C extension, built at first use).

The session solve runs on the device; the remaining critical path at
kubemark scale is Python bytecode over per-task object work.
``fastpath.c`` implements those loops against the CPython C API and this
package builds it with the system compiler the first time the package is
imported, into ``build/native/`` at the root of the checkout (listed in
``.gitignore``), under a name keyed by a hash of the source, the flags and
the interpreter, so a changed source or another Python builds anew and an
unchanged one is reused.  The build goes to a temporary file that is
renamed into place: processes that import the package at the same moment
(test workers) each load a whole library.

A failed build logs the compiler's stderr once and callers get ``None``
and use their Python loops, the same semantics (``status()`` says which).
Set ``KUBE_BATCH_TPU_NO_NATIVE=1`` to force the Python paths (the parity
tests compare both implementations).
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

from .. import knobs

log = logging.getLogger(__name__)

MODULE = "_fastpath_torch"
_SRC = Path(__file__).resolve().with_name("fastpath.c")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ("-O2", "-fPIC", "-shared")

_status: dict = {"loaded": False, "path": None, "build_seconds": None,
                 "error": None}


def _compiler() -> str:
    return (sysconfig.get_config_var("CC") or "cc").split()[0]


def library_path() -> Path:
    """Where the built library for this source, these flags and this
    interpreter lives."""
    include = sysconfig.get_paths()["include"]
    key = b"\0".join([_SRC.read_bytes(), " ".join(CFLAGS).encode(),
                      include.encode(),
                      sys.implementation.cache_tag.encode()])
    tag = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"{MODULE}_{tag}.{sys.implementation.cache_tag}.so"


def _build(so: Path) -> bool:
    include = sysconfig.get_paths()["include"]
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), *CFLAGS, f"-I{include}", str(_SRC), "-o", str(tmp)]
    began = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120, check=False)
    except (OSError, subprocess.SubprocessError) as exc:
        _status["error"] = f"{type(exc).__name__}: {exc}"
        return False
    if proc.returncode != 0 or not tmp.exists():
        _status["error"] = proc.stderr or f"exit code {proc.returncode}"
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)
    _status["build_seconds"] = time.perf_counter() - began
    return True


def _import(so: Path):
    spec = importlib.util.spec_from_file_location(MODULE, so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load():
    _status.update(loaded=False, path=None, build_seconds=None, error=None)
    if knobs.NO_NATIVE.enabled():
        _status["error"] = "disabled by KUBE_BATCH_TPU_NO_NATIVE"
        return None
    so = library_path()
    if not so.exists() and not _build(so):
        log.warning("native fast path: building %s failed; the Python "
                    "loops run instead:\n%s", _SRC, _status["error"])
        return None
    try:
        mod = _import(so)
    except (ImportError, OSError) as exc:
        _status["error"] = f"{type(exc).__name__}: {exc}"
        log.warning("native fast path: loading %s failed; the Python "
                    "loops run instead: %s", so, _status["error"])
        return None
    _status.update(loaded=True, path=str(so))
    return mod


def status() -> dict:
    """Whether the C walk loaded, the library's path, the seconds its
    build took in this process (None when an earlier build was reused)
    and, when it did not load, why (the compiler's stderr on a failed
    build)."""
    return dict(_status)


_mod = _load()
apply_placements = getattr(_mod, "apply_placements", None)
clone_task_map = getattr(_mod, "clone_task_map", None)
pod_static = getattr(_mod, "pod_static", None)
pod_static_setup = getattr(_mod, "pod_static_setup", None)
assume_walk = getattr(_mod, "assume_walk", None)
assume_setup = getattr(_mod, "assume_setup", None)
assume_group = getattr(_mod, "assume_group", None)
assume_insert = getattr(_mod, "assume_insert", None)
